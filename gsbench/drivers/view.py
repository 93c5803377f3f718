"""Serving traffic: one viewer flying a trained scene, a closed loop.

The viewer (the port's `NetworkGUI`, SIBR's remote protocol) asks for a
frame, waits for its bytes, then asks for the next: one client, one
request in flight. Each request is a pose of the path between
neighbouring held-out cameras of the orbit (the same poses for every
seed, in an order the seed shuffles); it goes through the port's
replayed exact render (`render.graph.render_replayed`) and the frame
comes back to the host as the viewer's uint8 HxWx3 bytes
(`NetworkGUI.image_to_bytes`). A request's latency runs from its issue
to its bytes on the host; the next is issued at once.

Set-up renders the held-out views at the default budgets and sizes the
budgets by the port's own rule (`pow2_budget` of twice the peak, as the
Trainer grows them), then serves requests at those budgets for
`warmup_seconds`, the time the service takes to settle on the card. The
check renders a seeded sample of the window's requests (a reservoir, so
the window keeps no more frames than it checks) with the plain reference
and compares the frames, level by level.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np
import torch

from gsbench import scene
from gsbench.drivers import common
from gsbench.drivers.common import (
    device_record, launches, log, pair_counts, ref_cam, synchronize,
)
from gsbench.reference import precision
from gsbench.reference import render as ref_render


def path_grid(cfg: dict, per_segment: int) -> list[tuple[float, float]]:
    """(angle, lift) of `per_segment` evenly spaced poses on each stretch
    of the orbit between two neighbouring held-out cameras."""
    _, test = scene.split(cfg)
    orbit = scene.orbit_angles(cfg)
    out = []
    for j in range(len(test)):
        a0, l0 = orbit[test[j]]
        a1, l1 = orbit[test[(j + 1) % len(test)]]
        if a1 < a0:
            a1 += 2.0 * math.pi
        for k in range(per_segment):
            t = (k + 0.5) / per_segment
            out.append((a0 + t * (a1 - a0), l0 + t * (l1 - l0)))
    return out


class Client:
    """One viewer: every seed asks for the same poses of the path grid, in
    an order the seed shuffles anew on each pass; a seeded reservoir keeps
    `keep` of the served frames for the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.grid = path_grid(cfg, traffic["poses_per_segment"])
        self.order = random.Random(seed)
        self.pick = random.Random(seed ^ 0x5EED)
        self.queue: list[tuple[float, float]] = []
        self.keep = traffic["check_frames"]
        self.kept: list[tuple[tuple[float, float], bytes]] = []
        self.served = 0
        self.latency: list[float] = []

    def next_pose(self) -> tuple[float, float]:
        if not self.queue:
            self.queue = list(self.grid)
            self.order.shuffle(self.queue)
        return self.queue.pop()

    def record(self, latency_s: float, pose, frame: bytes) -> None:
        self.latency.append(latency_s)
        if len(self.kept) < self.keep:
            self.kept.append((pose, frame))
        else:
            j = self.pick.randrange(self.served + 1)
            if j < self.keep:
                self.kept[j] = (pose, frame)
        self.served += 1


def pose_views(cfg: dict, pose_list, dev) -> scene.Views:
    fx, fy = scene.fovs(cfg)
    return scene.views_from_matrices([scene.orbit_pose(cfg, a, lift) for a, lift in pose_list],
                                     fx, fy, cfg["width"], cfg["height"], dev)


def request_camera(cfg: dict, pose, dev):
    """The port's Camera of one pose, its tensors one upload's slices."""
    from gsjax_torch.core.cameras import Camera

    fx, fy = scene.fovs(cfg)
    view = scene.orbit_pose(cfg, *pose)
    full = (scene.projection_matrix(fx, fy) @ view).astype(np.float32)
    center = np.linalg.inv(view.astype(np.float64))[:3, 3]
    flat = np.concatenate([view.ravel(), full.ravel(), center,
                           [math.tan(fx / 2.0), math.tan(fy / 2.0)]]).astype(np.float32)
    t = torch.from_numpy(flat).to(dev)
    return Camera(view=t[0:16].view(4, 4), full_proj=t[16:32].view(4, 4), cam_center=t[32:35],
                  tan_fovx=t[35], tan_fovy=t[36], width=cfg["width"], height=cfg["height"])


def program_camera(v: scene.Views, i: int):
    from gsjax_torch.core.cameras import Camera

    return Camera(view=v.views[i], full_proj=v.full_projs[i], cam_center=v.centers[i],
                  tan_fovx=v.tan_fovx[i], tan_fovy=v.tan_fovy[i], width=v.width, height=v.height)


def frame_gaps(frame: np.ndarray, ref_image: torch.Tensor) -> tuple[float, float]:
    """(mean, max) |program - reference| in uint8 levels of one frame,
    the reference's frame made as the viewer makes its bytes."""
    ref = (torch.clamp(ref_image, 0.0, 1.0) * 255.0).to(torch.uint8).permute(1, 2, 0)
    d = np.abs(frame.astype(np.int16) - ref.cpu().numpy().astype(np.int16))
    return float(d.mean()), float(d.max())


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault: str | None = None, control: bool = False) -> dict:
    from gsjax_torch.config import pow2_budget
    from gsjax_torch.model import GaussianAux, pad_gaussian_params
    from gsjax_torch.render.graph import captures, drop_render_graphs, render_replayed
    from gsjax_torch.viewer.network_gui import NetworkGUI

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"imports and CUDA context: {time.perf_counter() - t_start:.2f} s from start")
    raw = scene.gaussians(cfg, seed, dev)
    n = raw["xyz"].shape[0]
    cap = scene.capacity_for(n)
    params = pad_gaussian_params(**raw, capacity=cap)
    alive = GaussianAux.create(cap, n, dev).alive
    del raw
    bg = torch.zeros(3, device=dev)
    deg = cfg["sh_degree"]
    rcfg = common.raster_config(cfg)

    def serve(cam, rc):
        return render_replayed(params, cam, active_sh_degree=deg, bg_color=bg, cfg=rc,
                               alive=alive)

    held = scene.camera_set(cfg, "test", dev)
    synchronize(dev)
    log(f"inputs: {time.perf_counter() - t_start:.2f} s from start")
    while True:  # the Trainer's rule: grow past 60 % to twice the peak
        peak_i = peak_r = 0
        for i in range(held.count):
            out = serve(program_camera(held, i), rcfg)
            peak_i = max(peak_i, int(out.num_instances))
            peak_r = max(peak_r, int(out.num_rows))
        grown = dataclasses.replace(
            rcfg,
            max_instances=pow2_budget(2 * peak_i) if peak_i > 0.6 * rcfg.max_instances
            else rcfg.max_instances,
            max_rows=pow2_budget(2 * peak_r) if peak_r > 0.6 * rcfg.max_rows else rcfg.max_rows)
        if grown == rcfg:
            break
        rcfg = grown
    log(f"budgets and captures: {time.perf_counter() - t_start:.2f} s from start")
    overflow: list[torch.Tensor] = []
    fills: list[torch.Tensor] = []
    record: dict = {"gaussians": n}
    prev = []
    events: list = []  # each request's render between two CUDA events

    def one(client: Client):
        """The client's next request, issued as its last one's bytes
        arrived; its latency runs from its issue to its frame's bytes on
        the host."""
        t_issue = time.perf_counter()
        pose = client.next_pose()
        cam = request_camera(cfg, pose, dev)
        if dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        # A fault: the frame of the previous request served for this one.
        out = serve(prev[0] if fault == "stale" and prev else cam, rcfg)
        if dev.type == "cuda":
            ev[1].record()
            events.append(ev)
        frame = NetworkGUI.image_to_bytes(out.image)
        t_done = time.perf_counter()
        client.record(t_done - t_issue, pose, frame)
        prev[:] = [cam]
        # Pairs past the budget are dropped: that frame is wrong.
        overflow.append(out.num_instances > rcfg.max_instances)
        return pose, out, t_done - t_issue

    # Warm-up: the window's own requests, on poses of an order of their
    # own, so the window's requests are the seed's whatever it served.
    warm = Client(cfg, traffic, seed ^ 0x3A3A)
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < traffic["warmup_seconds"]:
        one(warm)
    log(f"set-up: budgets {rcfg.max_instances}/{rcfg.max_rows} (peaks {peak_i}/{peak_r}), "
        f"{len(captures)} captures; warm-up {warm.served} requests, median ms by fifth "
        + " ".join(f"{np.median(c) * 1e3:.2f}" for c in np.array_split(warm.latency, 5)
                   if len(c)))
    caps = len(captures)
    for kept in (overflow, events, prev):
        kept.clear()
    client = Client(cfg, traffic, seed)

    synchronize(dev)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if not trace:
        while time.perf_counter() - t_window < seconds:
            one(client)
    else:
        _traced_window(lambda: one(client), seconds, t_window, dev, record, fills,
                       traffic["profiled_requests"])
    wall = time.perf_counter() - t_window
    if len(captures) != caps:
        log(f"WARNING: {len(captures) - caps} capture(s) inside the window")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record["fills"] = [float(f) / rcfg.max_instances for f in torch.stack(fills).cpu().tolist()] \
        if fills else []
    lat = np.asarray(client.latency) * 1e3
    log(f"window: {client.served} requests in {wall:.2f} s; latency ms p50 "
        f"{np.percentile(lat, 50):.2f} p90 {np.percentile(lat, 90):.2f} p95 "
        f"{np.percentile(lat, 95):.2f} p99 {np.percentile(lat, 99):.2f} max {lat.max():.2f}")
    log("window: latency p95 ms by fifth of the requests " + " ".join(
        f"{np.percentile(c, 95):.2f}" for c in np.array_split(lat, 5) if len(c)))
    if events:  # the render's device time apart from the host's share
        dms = np.asarray([e0.elapsed_time(e1) for e0, e1 in events])
        record["render_ms"] = dms.tolist()
        log(f"window: render ms between CUDA events p50 {np.percentile(dms, 50):.2f} p95 "
            f"{np.percentile(dms, 95):.2f}, p95 by fifth " + " ".join(
                f"{np.percentile(c, 95):.2f}" for c in np.array_split(dms, 5) if len(c)))
        rest = lat - dms  # upload, the host's share of the replay, the frame's bytes
        log(f"window: the rest of a request ms p50 {np.percentile(rest, 50):.2f} p95 "
            f"{np.percentile(rest, 95):.2f}, p95 by fifth " + " ".join(
                f"{np.percentile(c, 95):.2f}" for c in np.array_split(rest, 5) if len(c)))
    failed = int(torch.stack(overflow).sum()) if overflow else 0
    del params, alive
    drop_render_graphs()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out = {"attempted": client.served, "failed": failed,
           "e2e": {"view_ms_p95": float(np.percentile(lat, 95)),
                   "views_per_s": client.served / wall, "setup_s": setup_s,
                   "peak_mem_gib": peak / 2**30},
           "device": device_record(dev, peak), "record": record}
    raw = scene.gaussians(cfg, seed, dev)
    if trace:
        pv = pose_views(cfg, record.pop("profiled_poses"), dev)
        record["views"] = pair_counts(raw, pv, range(pv.count), deg)
        out["device"].update(busy_s=record["busy_s"], window_s=record["session_window_s"])
        out["breakdown"] = record.pop("breakdown")
    out["numbers"] = check(cfg, raw, client.kept, dev, bg, control)
    return out


def check(cfg: dict, raw: dict, kept: list, dev, bg: torch.Tensor, control: bool) -> dict:
    """The kept frames against the reference's render of the same pose:
    the worst frame's mean level gap and the largest level gap."""
    h, w = cfg["height"], cfg["width"]
    mean_gap = max_gap = 0.0
    for pose, frame_bytes in kept:
        v = pose_views(cfg, [pose], dev)
        ref = ref_render.render(raw, ref_cam(v, 0), bg, cfg["sh_degree"]).image
        if control:  # the reference in TF32, in the program's place
            with precision(True):
                img = ref_render.render(raw, ref_cam(v, 0), bg, cfg["sh_degree"]).image
            frame = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).permute(1, 2, 0)
            frame = frame.cpu().numpy()
        else:
            frame = np.frombuffer(frame_bytes, np.uint8).reshape(h, w, 3)
        mg, xg = frame_gaps(frame, ref)
        mean_gap, max_gap = max(mean_gap, mg), max(max_gap, xg)
    log(f"check: {len(kept)} frames, mean gap {mean_gap}, max gap {max_gap}")
    return {"frame_mean_gap": mean_gap, "frame_max_gap": max_gap}


def _traced_window(one, seconds: float, t_window: float, dev, record: dict, fills: list,
                   count: int) -> None:
    """The window with one whole profiler session over `count` requests in
    its middle; the poses and budget fills of those requests recorded."""
    from gsbench import session

    while time.perf_counter() - t_window < seconds / 2:
        one()
    poses: list = []
    service: list = []

    def body():
        poses.clear()
        fills.clear()
        service.clear()
        for _ in range(count):
            pose, out, s = one()
            poses.append(pose)
            fills.append(out.num_instances)
            service.append(s)

    if dev.type == "cuda":
        sess = session.profile(body, launches)
        record.update(ops=sess.ops, session_window_s=sess.window_s,
                      busy_s=session.busy_s(sess.ops), sessions_refused=sess.refused,
                      breakdown={"device_ops": session.top_ops(sess.ops),
                                 "idle_gaps": session.idle_gaps(sess.ops)})
    else:
        t1 = time.perf_counter()
        body()
        record.update(ops=[], session_window_s=time.perf_counter() - t1, busy_s=0.0,
                      sessions_refused=[], breakdown=None)
    record["profiled_requests"] = count
    record["profiled_poses"] = list(poses)
    record["item_s"] = sum(service) / len(service)
    while time.perf_counter() - t_window < seconds:
        one()
