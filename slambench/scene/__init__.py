"""The harness's own synthetic scene: a textured box room, the camera
trajectories and a ray-casting renderer in PyTorch (``render.py``), and a
frozen numpy copy of the port's renderer that the tests hold it to
(``frozen_np.py``)."""
