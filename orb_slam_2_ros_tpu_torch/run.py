"""CLI runner: the port's executable in place of the reference's ROS nodes.

    python -m orb_slam_2_ros_tpu_torch.run --dataset tum --path tests/data/mini_tum
    python -m orb_slam_2_ros_tpu_torch.run --dataset synthetic --frames 60 --device cpu

The port of ``orb_slam_2_ros_tpu/run.py``: runs the full pipeline over a
dataset and prints each chunk's tracking state, the run's summary and the
ATE. ``--dataset tum|kitti|euroc --path <dir>`` reads real frames, decoded
on the host by the native library and streamed by its prefetcher in wire
format; ``--sensor`` picks the pipeline as choosing the executable does
(``orb_slam2_ros_{mono,stereo,rgbd}``); ``--save-map`` / ``--load-map``
stand in for the SaveMap service (``srv/SaveMap.srv``); ``--save-traj`` for
the save at shutdown (``ros/src/Node.cc:13-21``); ``--localization-only``
for the dynamic-reconfigure switch. Loop closing and the background global
BA run by default (``--no-loop-closing`` turns them off). Without
``--vocab`` a vocabulary is trained from the sequence's own frames.

The device is ``--device``, the card (``cuda``) by default; without a card
the run raises unless ``--device cpu`` is given. ``--profile DIR`` writes a
``torch.profiler`` trace of the tracked chunks.

``--mesh`` runs the back end over a mesh of process groups
(``parallel/``): the local BA's rows and the loop GBA's points and edges
split over its ranks, one rank per card (NCCL; gloo with ``--device
cpu``). Alone it makes a world of 1; under ``torchrun --nproc-per-node N``
the world is torchrun's; ``--coordinator host:port --num-hosts N
--host-id i`` joins one rank per host. Every rank runs the whole program
on the same frames and prints ``rank r: mesh {...} over N ranks
(backend)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="ORB-SLAM2-class engine on PyTorch and CUDA")
    ap.add_argument("--dataset",
                    choices=["synthetic", "tum", "kitti", "euroc"],
                    default="synthetic")
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"],
                    help="default: rgbd for tum/synthetic, stereo for "
                         "kitti/euroc")
    ap.add_argument("--path", help="dataset directory (tum/kitti/euroc)")
    ap.add_argument("--preset",
                    help="camera preset (tum1/tum2/tum3/kitti/euroc/r200/"
                         "d435/mynteye/zed2), as choosing a launch file; "
                         "defaults per dataset")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-ba", action="store_true", help="disable local BA")
    ap.add_argument("--loop-closing", dest="loop_closing",
                    action="store_true", default=True,
                    help="loop detection, Sim3 correction and background "
                         "global BA (on by default, as in the reference)")
    ap.add_argument("--no-loop-closing", dest="loop_closing",
                    action="store_false")
    ap.add_argument("--localization-only", action="store_true")
    ap.add_argument("--save-map", help="write the map npz on exit")
    ap.add_argument("--load-map", help="load a map npz at the start")
    ap.add_argument("--merge-map",
                    help="merge a saved session's map npz into this run's "
                         "map after tracking")
    ap.add_argument("--vocab", help="vocabulary file (.bin/.txt/.npz)")
    ap.add_argument("--gt-poses",
                    help="KITTI ground-truth poses file for --dataset kitti "
                         "(ATE and t_rel/r_rel)")
    ap.add_argument("--save-traj", help="write the TUM trajectory on exit")
    ap.add_argument("--save-kf-traj", help="write the TUM keyframe "
                                           "trajectory")
    ap.add_argument("--save-debug-image",
                    help="write the last annotated frame as a PNG")
    ap.add_argument("--profile",
                    help="write a torch.profiler trace of the run to this "
                         "directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    # multi-host runtime: every rank runs this same command; the loop GBA
    # and the windowed BA split over the global mesh
    ap.add_argument("--coordinator",
                    help="host:port of rank 0's rendezvous store "
                         "(multi-host jobs; omit on a single host)")
    ap.add_argument("--num-hosts", type=int, default=None)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="build a mesh over all (local or global) ranks "
                         "and route the loop GBA + windowed BA through it "
                         "(parallel/dist_ba.py)")
    ap.add_argument("--render-workers", type=int, default=1,
                    help="synthetic dataset: render the frames up front in "
                         "this many processes (default 1: each frame when "
                         "its chunk is tracked)")
    return ap


class _Rendered:
    """A synthetic sequence rendered up front: the dataset's frames by
    index, its timestamps and its ground truth."""

    def __init__(self, ds, grays, auxs):
        self.ds, self.grays, self.auxs = ds, grays, auxs
        self.timestamps = ds.timestamps

    def __len__(self):
        return len(self.grays)

    def __getitem__(self, i):
        return self.grays[i], self.auxs[i]

    def gt_pose_wc(self, i):
        return self.ds.gt_pose_wc(i)


def _dataset(args, sensor):
    """(cfg, dataset, ground-truth centres or None) for the arguments."""
    from orb_slam_2_ros_tpu_torch import presets
    from orb_slam_2_ros_tpu_torch.config import SENSOR_STEREO, SlamConfig
    from orb_slam_2_ros_tpu_torch.io import datasets

    preset_name = args.preset or {"synthetic": None, "tum": "tum1",
                                  "kitti": "kitti", "euroc": "euroc"}[
        args.dataset]
    if args.dataset == "synthetic":
        from orb_slam_2_ros_tpu_torch.io import synthetic
        cfg = (presets.get(preset_name, sensor) if preset_name
               else SlamConfig(sensor=sensor))
        stereo = sensor == SENSOR_STEREO
        if args.render_workers > 1:
            ds = _Rendered(*synthetic.render_frames(
                cfg, args.frames, args.render_workers, stereo=stereo,
                seed=args.seed))
        else:
            cls = synthetic.SyntheticStereo if stereo else \
                synthetic.SyntheticRGBD
            ds = cls(cfg, n_frames=args.frames, seed=args.seed)
        return cfg, ds, np.stack([ds.gt_pose_wc(i)[1]
                                  for i in range(len(ds))])
    cfg = presets.get(preset_name, sensor)
    if args.dataset == "tum":
        return cfg, datasets.TumRGBD(args.path,
                                     cfg.camera.depth_map_factor), None
    # KITTI: per-sequence intrinsics from calib.txt (the camera_info
    # equivalent, ros/src/Node.cc:336-358); EuRoC: the rectified intrinsics
    # from the dataset's sensor.yaml pair
    ds = (datasets.KittiOdometry(args.path) if args.dataset == "kitti"
          else datasets.EurocMav(args.path))
    calib = ds.calibration()
    if calib is not None:
        cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, **calib))
    return cfg, ds, None


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.dataset in ("tum", "kitti", "euroc") and not args.path:
        ap.error(f"--dataset {args.dataset} requires --path")
    if args.coordinator and (args.num_hosts is None or args.host_id is None):
        ap.error("--coordinator requires --num-hosts and --host-id")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the run uses the CUDA device by default and "
            "torch.cuda.is_available() is False; pass --device cpu to run "
            "on the CPU")

    mesh = None
    made_group = False
    if args.coordinator or args.mesh:
        from torch import distributed as dist

        from orb_slam_2_ros_tpu_torch.parallel import multihost
        made_group = not dist.is_initialized()
        rank = multihost.initialize(args.coordinator, args.num_hosts,
                                    args.host_id, device=device)
        mesh = multihost.global_mesh(device=device)
        print(f"rank {rank}: mesh {mesh.shape} over {mesh.world} ranks "
              f"({dist.get_backend()})", flush=True)
        device = mesh.device
    try:
        return _run(args, device, mesh)
    finally:
        if made_group:
            multihost.shutdown()


def _run(args, device, mesh):
    from orb_slam_2_ros_tpu_torch.config import (SENSOR_MONOCULAR,
                                                 SENSOR_RGBD, SENSOR_STEREO)
    from orb_slam_2_ros_tpu_torch.io import datasets, trajectory
    from orb_slam_2_ros_tpu_torch.pipeline import frame_drawer
    from orb_slam_2_ros_tpu_torch.pipeline.slam import System
    from orb_slam_2_ros_tpu_torch.pipeline.tracking import OK
    from orb_slam_2_ros_tpu_torch.place import vocabulary

    sensor_name = args.sensor or {"synthetic": "rgbd", "tum": "rgbd",
                                  "kitti": "stereo", "euroc": "stereo"}[
        args.dataset]
    sensor = {"mono": SENSOR_MONOCULAR, "stereo": SENSOR_STEREO,
              "rgbd": SENSOR_RGBD}[sensor_name]
    cfg, ds, gt = _dataset(args, sensor)
    if args.localization_only:
        cfg = cfg.replace(localization_only=True)

    vocab = None
    if args.vocab:
        vocab = (vocabulary.load_npz(args.vocab, device=device)
                 if args.vocab.endswith(".npz")
                 else vocabulary.load_orbvoc(args.vocab, cfg, device=device))
    elif args.loop_closing and not args.load_map:
        # no vocabulary file: train one on the sequence's own imagery
        # (in-domain self-training retrieves far better than the
        # random-descriptor fallback of slam.default_vocabulary)
        n_total = min(len(ds), args.frames)
        sample = range(0, n_total, max(1, n_total // 6))
        descs = vocabulary.frame_descriptors(
            [ds[i][0] for i in sample], range(len(sample)), cfg, device)
        print(f"training vocabulary on {len(descs)} descriptors from "
              f"{len(sample)} frames...", flush=True)
        vocab = vocabulary.train_vocabulary(descs, cfg, seed=args.seed,
                                            device=device)
    sys_ = System(cfg, enable_local_ba=not args.no_ba,
                  load_map=args.load_map,
                  enable_loop_closing=args.loop_closing, vocab=vocab,
                  device=device, mesh=mesh)

    n = min(len(ds), args.frames) if args.dataset != "synthetic" else len(ds)
    chunk = sys_.tracker.chunk
    # file datasets stream through the native threaded prefetcher
    # (C++ decode into wire-format buffers that overlaps the device,
    # io/datasets.make_prefetcher); the others are indexed
    prefetch = (datasets.make_prefetcher(ds)
                if args.dataset != "synthetic" else None)

    def load_chunk(i, j):
        if prefetch is not None:
            frames = [prefetch.next() for _ in range(j - i)]
            a = np.stack([f[0] for f in frames])
            b = (np.stack([f[1] for f in frames])
                 if frames[0][1] is not None else None)
            return a, b
        a = np.stack([ds[k][0] for k in range(i, j)])
        b = np.stack([ds[k][1] for k in range(i, j)])
        return a, b

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    t_start = time.perf_counter()
    for i in range(0, n, chunk):
        j = min(i + chunk, n)
        a, b = load_chunk(i, j)
        if sensor == SENSOR_MONOCULAR:
            b = None
        recs = sys_.track_chunk(a, b, list(ds.timestamps[i:j]))
        ok = sum(r.state == OK for r in recs)
        kfs = sum(r.is_keyframe for r in recs)
        last = recs[-1].n_inliers if recs else 0
        print(f"[{i:4d}-{j:4d}) tracked {ok}/{len(recs)} (+{kfs} KF, "
              f"inliers {last})", flush=True)
    sys_.flush()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    if prefetch is not None:
        prefetch.close()
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        out = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(out)
        print("profiler trace ->", out)

    est = np.stack([r.c_w for r in sys_.records])
    print(f"done: {n} frames in {dt:.1f}s ({n / dt:.1f} fps incl. host IO), "
          f"{int(np.sum([r.is_keyframe for r in sys_.records]))} keyframes, "
          f"{len(sys_.map_points())} map points")
    if sys_.loop_closer is not None:
        print(f"loops closed: {sys_.loop_closer.n_loops_closed}")
    mx = sys_.metrics()
    # the top-level spans; their dotted parts stay in ``mx["stages"]``
    stage_str = ", ".join(f"{k} {v['mean_ms']:.1f}ms"
                          for k, v in mx["stages"].items() if "." not in k)
    print(f"metrics: {mx['keyframes']} KFs, {mx['map_points']} points, "
          f"{mx['points_culled']} culled, {mx['resets']} resets | {stage_str}")
    result = {"frames": n, "seconds": dt, "fps": n / dt,
              "ok": sum(r.state == OK for r in sys_.records),
              "system": sys_}
    if gt is not None:
        ate = trajectory.ate_rmse(est, gt,
                                  with_scale=(sensor == SENSOR_MONOCULAR))
        print(f"ATE RMSE vs ground truth: {ate:.4f} m")
        result["ate_m"] = ate
    # dataset ground truth (TUM groundtruth.txt, KITTI poses file): the
    # composed trajectory evaluated as evo and the KITTI devkit do
    gt_poses = None
    if args.dataset == "kitti" and args.gt_poses:
        ds.poses_file = args.gt_poses
        _, gt_poses = ds.gt_trajectory()
        est_poses, est_ts = sys_.tracker.composed_trajectory(skip_lost=False)
        gt_poses = gt_poses[:len(est_poses)]
    elif (args.dataset == "tum"
          and os.path.exists(os.path.join(args.path, "groundtruth.txt"))):
        gt_ts, gt_all = ds.gt_trajectory()
        est_poses, est_ts = sys_.tracker.composed_trajectory()
        pairs = datasets.associate(np.asarray(est_ts), np.asarray(gt_ts))
        gt_poses = [gt_all[j] for _, j in pairs]
        est_poses = [est_poses[i] for i, _ in pairs]
    if gt_poses:
        gt_c = np.stack([c for _, c in gt_poses])
        est_c = np.stack([c for _, c in est_poses])
        ate = trajectory.ate_rmse(est_c, gt_c,
                                  with_scale=(sensor == SENSOR_MONOCULAR))
        print(f"ATE RMSE vs dataset ground truth: {ate:.4f} m "
              f"({len(gt_poses)} poses)")
        result["ate_dataset_m"] = ate
        t_rel, r_rel, n_sub = trajectory.kitti_relative_error(est_poses,
                                                              gt_poses)
        if n_sub:
            print(f"relative error: t_rel {100 * t_rel:.2f} %, "
                  f"r_rel {r_rel * 100 * 180 / np.pi:.3f} deg/100m "
                  f"({n_sub} subsequences)")
    if args.save_traj:
        sys_.save_trajectory_tum(args.save_traj)
        print("trajectory ->", args.save_traj)
    if args.save_kf_traj:
        sys_.save_keyframe_trajectory_tum(args.save_kf_traj)
    if args.merge_map:
        ok = sys_.merge_map(args.merge_map)
        print(f"merge {args.merge_map}: {'aligned' if ok else 'REJECTED'}; "
              f"{len(sys_.map_points())} points total")
    if args.save_map:
        sys_.save_map(args.save_map)
        print("map ->", args.save_map)
    if args.save_debug_image:
        img = sys_.render_debug_image()
        if img is not None:
            frame_drawer.write_png(args.save_debug_image, img)
            print("debug image ->", args.save_debug_image)
    return result


if __name__ == "__main__":
    main()
