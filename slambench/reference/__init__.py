"""The plain references that decide ``correct``. They import neither JAX,
nor the JAX package, nor anything of the port, and take nothing that the
port made: the images they read are the harness's own, and the port's
outputs are read only to be judged."""
