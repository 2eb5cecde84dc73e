"""Sharded bundle adjustment, detection and matching over a mesh of shards.

Port of ``imageanalysis_tpu/parallel/sharded.py``. A mesh is R shards,
each with a device; a function runs on every shard in lockstep
(``mesh.map``), and shards meet only in sums (``ShardContext.sum``,
bitwise alike on every shard) and gathers. Two forms:

- ``ProcessMesh``: one shard a rank of the process group
  (parallel/multihost.py), sums by ``torch.distributed.all_reduce``;
- ``LocalMesh``: R shards in one process on the devices it is given (a
  device may repeat), one thread a shard; sums in shard order on the
  first device. The counterpart of the reference's virtual CPU devices,
  and ``stages optimize --mesh N`` over N cards.

BA is data-parallel over observations. ``solve_sharded`` partitions
chain-ordered observations at point boundaries (``PointPartition``), so
each point's observations lie on one shard: point sums stay on the
shard, and the only collective of a CG iteration is the (n_cam, 7)
camera sum; per outer LM iteration one fused sum of (g_c, Hcc), per
damped solve one (n_pt_pad, 3) sum assembling Δpts, and per cost the
sums of ½‖r‖², Σ|r| and Σw and the maximum of |r|. Cameras and points
are replicated on every shard. ``sharded_lm_step`` is the
observation-sharded step instead (observations split evenly, every sum
summed). Detection and matching split their image or pair axis and
gather the outputs, with no other communication.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

from ..ba import bundle


def _indexed(device):
    """device with its index: "cuda" is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardContext:
    """One shard's handle inside mesh.map: its index, its device, and the
    collectives with the other shards."""

    def __init__(self, mesh, index, device):
        self.mesh = mesh
        self.index = index
        self.device = device

    def sum(self, *tensors):
        """Each tensor summed over every shard (one collective for all of
        them; one dtype), on this shard's device."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        out = self.mesh._reduce(self, flat, "sum")
        parts, o = [], 0
        for t in tensors:
            parts.append(out[o:o + t.numel()].reshape(t.shape))
            o += t.numel()
        return tuple(parts)

    def max(self, t):
        """t's elementwise maximum over every shard."""
        return self.mesh._reduce(self, t.reshape(-1), "max").reshape(t.shape)

    def reduce(self, points_local=True):
        """This shard's bundle.ShardReduce."""
        return bundle.ShardReduce(self.sum, points_local)


class _Mesh:
    """Common part of the two meshes: collective counts (calls and bytes,
    counted once for all shards), the shards' devices."""

    def __init__(self, devices, shards, local):
        self.shards = shards                # R, the shards in all
        self.local = local                  # this process's shard indices
        self.devices = devices              # their devices, in that order
        self.home = devices[0]              # where replicated results land
        self.stats = {"calls": 0, "bytes": 0}

    def _count(self, ctx, flat):
        if ctx.index == self.local[0]:
            self.stats["calls"] += 1
            self.stats["bytes"] += flat.numel() * flat.element_size()

    def shard_of(self, n, i):
        """Rows [a, b) of shard i when n rows split evenly (n a multiple
        of the shard count: the reference's shardings need one too)."""
        if n % self.shards:
            raise ValueError(f"{n} rows do not split over {self.shards} "
                             "shards; pad them to a multiple")
        per = n // self.shards
        return i * per, (i + 1) * per


class ProcessMesh(_Mesh):
    """One shard a rank of the initialized process group, on device (the
    rank's own: multihost.rank_device)."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs the process group "
                               "(multihost.maybe_initialize_distributed)")
        super().__init__([_indexed(device)], dist.get_world_size(),
                         [dist.get_rank()])

    def map(self, fn, items):
        """[fn(ShardContext, items[0])]: this rank's shard."""
        return [fn(ShardContext(self, self.local[0], self.home), items[0])]

    def _reduce(self, ctx, flat, op):
        self._count(ctx, flat)
        out = flat.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX)
        return out

    def gather(self, parts, n):
        """The full (n, ...) tensor on the home device from this rank's
        rows (parts[0], rows shard_of(n, rank)): a sum of zero buffers
        each holding one rank's rows, exact."""
        part = parts[0]
        a, b = self.shard_of(n, self.local[0])
        kind = part.dtype
        wide = kind if kind.is_floating_point else torch.int32
        buf = torch.zeros((n,) + tuple(part.shape[1:]), dtype=wide,
                          device=self.home)
        buf[a:b] = part.to(self.home, wide)
        self._count(ShardContext(self, self.local[0], self.home),
                    buf.reshape(-1))
        dist.all_reduce(buf)
        return buf.to(kind)


class _Aborted(Exception):
    """A shard of a LocalMesh failed; the others stop at their turn."""


class LocalMesh(_Mesh):
    """R shards in this process, shard i on devices[i] (a device may
    repeat); mesh.map runs one thread a shard, and sums go in shard order
    on the first device, then back to each shard's device. One thread
    runs shard code at a time: a turn passes around the ring 0, 1, …,
    R − 1 at each collective, and the last shard sums. Forward-mode AD
    (BA's jacobians) keeps its state process-wide, and a card takes one
    host's launches in order either way."""

    def __init__(self, devices):
        devices = [_indexed(d) for d in devices]
        super().__init__(devices, len(devices), list(range(len(devices))))
        self._slots = [None] * len(devices)
        self._turn = None
        self._failed = False
        self._result = None

    def map(self, fn, items):
        """[fn(ShardContext i, items[i]) for every shard], run in lockstep
        (a thread a shard); the first failure is raised after every
        thread has ended."""
        R = self.shards
        if R == 1:
            return [fn(ShardContext(self, 0, self.home), items[0])]
        self._turn = [threading.Semaphore(0) for _ in range(R)]
        self._failed = False
        out, errs = [None] * R, [None] * R

        def run(i):
            try:
                self._wait_turn(i)
                if self.devices[i].type == "cuda":
                    torch.cuda.set_device(self.devices[i])
                out[i] = fn(ShardContext(self, i, self.devices[i]), items[i])
            except BaseException as e:  # noqa: BLE001 — raised below
                errs[i] = e
                self._failed = True
            self._turn[(i + 1) % R].release()

        threads = [threading.Thread(target=run, args=(i,)) for i in range(R)]
        for t in threads:
            t.start()
        self._turn[0].release()
        for t in threads:
            t.join()
        first = next((e for e in errs if e is not None
                      and not isinstance(e, _Aborted)),
                     next((e for e in errs if e is not None), None))
        if first is not None:
            raise first
        return out

    def _wait_turn(self, i):
        self._turn[i].acquire()
        if self._failed:
            raise _Aborted()

    def _reduce(self, ctx, flat, op):
        self._count(ctx, flat)
        R = self.shards
        if R == 1:
            return flat.clone()
        i = ctx.index
        self._slots[i] = flat
        if i == R - 1:
            # every shard has put its part: sum them in shard order; each
            # shard reads the sum at its turn, before this shard next sums
            acc = self._slots[0].to(self.home)
            for s in self._slots[1:]:
                s = s.to(self.home)
                acc = acc + s if op == "sum" else torch.maximum(acc, s)
            self._result = acc
            self._slots = [None] * R
        self._turn[(i + 1) % R].release()
        self._wait_turn(i)
        return self._result.to(ctx.device)

    def gather(self, parts, n):
        """The full (n, ...) tensor on the first device from every shard's
        rows, in shard order."""
        return torch.cat([p.to(self.home) for p in parts])


def pad_observations(obs, multiple):
    """Pad the observation axis to a multiple with weight-0 rows (inert).
    pt_idx pads with its LAST value, not 0: chain-ordered setups have a
    sorted pt_idx, which a 0 tail would break. numpy in and out."""
    cam, pt, uv, w = (bundle._np(x) for x in obs)
    n = len(uv)
    n_pad = ((n + multiple - 1) // multiple) * multiple
    if n_pad == n:
        return bundle.BAObservations(cam, pt, uv, w)
    extra = n_pad - n
    pt_fill = pt[-1] if len(pt) else 0
    return bundle.BAObservations(
        cam_idx=np.concatenate([cam, np.zeros(extra, cam.dtype)]),
        pt_idx=np.concatenate([pt, np.full(extra, pt_fill, pt.dtype)]),
        uv=np.concatenate([uv, np.zeros((extra, 2), uv.dtype)]),
        weight=np.concatenate([w, np.zeros(extra, w.dtype)]))


def shard_observations(obs, mesh):
    """Pad obs to a multiple of the shard count and split it evenly:
    [each local shard's BAObservations of tensors on its device]."""
    obs = pad_observations(obs, mesh.shards)
    out = []
    for i, dev in zip(mesh.local, mesh.devices):
        a, b = mesh.shard_of(len(obs.uv), i)
        out.append(bundle.observations_on(
            bundle.BAObservations(*(x[a:b] for x in obs)), dev,
            torch.float32))
    return out


def sharded_lm_step(mesh, cg_iters=40, cg_tol=1e-3):
    """The observation-sharded LM step: observations split evenly over the
    shards (shard_observations), every camera and point sum summed over
    them. Returns step(cams, pts, obs_shards, K, dist, lam) →
    (Δcams, Δpts, predicted decrease), replicated, on the home device."""

    def step(cams, pts, obs_shards, K, dist, lam):
        n_cam, n_pt = cams.shape[0], pts.shape[0]

        def run(ctx, o):
            on = [x.to(ctx.device) for x in (cams, pts, K, dist)]
            red = ctx.reduce(points_local=False)
            jac = bundle.lm_jacobians(on[0], on[1], o, on[2], on[3], n_cam,
                                      n_pt, reduce=red)
            return bundle.lm_solve(jac, o.cam_idx, o.pt_idx, lam,
                                   cg_iters=cg_iters, cg_tol=cg_tol,
                                   reduce=red)

        return tuple(x.to(mesh.home) for x in mesh.map(run, obs_shards)[0])

    return step


class PointPartition:
    """Host partition of chain-ordered observations into equal-length
    per-shard chunks that never split a point across shards (the
    reference's, field for field).

    Attributes (R = n_shards, L = padded obs/shard, M = padded pts/shard):
      cam_idx (R·L,) int32; ptl_idx (R·L,) int32 LOCAL point ids;
      uv (R·L, 2) f32; weight (R·L,) f32 (0 on padding);
      pt_off (R,) first global point of each shard; m_pts (R,) real point
      count per shard; n_pt_pad ≥ max(pt_off + M) scatter bound."""

    def __init__(self, obs, n_pt, n_shards):
        pt = bundle._np(obs.pt_idx)
        cam = bundle._np(obs.cam_idx)
        uv = bundle._np(obs.uv)
        w = bundle._np(obs.weight)
        if not np.all(np.diff(pt) >= 0):
            order = np.argsort(pt, kind="stable")
            pt, cam, uv, w = pt[order], cam[order], uv[order], w[order]
        n = len(pt)
        splits = [0]
        for s in range(1, n_shards):
            t = min(round(s * n / n_shards), n)
            while 0 < t < n and pt[t] == pt[t - 1]:
                t += 1
            splits.append(max(min(t, n), splits[-1]))
        splits.append(n)
        self.L = L = max(1, int(np.max(np.diff(splits))))
        pt_lo = np.zeros(n_shards + 1, np.int64)
        for s in range(1, n_shards):
            lo = pt[splits[s]] if splits[s] < n else n_pt
            pt_lo[s] = max(lo, pt_lo[s - 1])
        pt_lo[n_shards] = n_pt
        self.M = M = max(1, int(np.max(np.diff(pt_lo))))
        self.pt_off = pt_lo[:n_shards].astype(np.int32)
        self.m_pts = np.diff(pt_lo).astype(np.int32)
        self.n_pt_pad = int(self.pt_off.max()) + M
        R = n_shards
        self.cam_idx = np.zeros(R * L, np.int32)
        self.ptl_idx = np.zeros(R * L, np.int32)
        self.uv = np.zeros((R * L, 2), np.float32)
        self.weight = np.zeros(R * L, np.float32)
        for s in range(R):
            a, b = splits[s], splits[s + 1]
            k = b - a
            self.cam_idx[s * L:s * L + k] = cam[a:b]
            self.ptl_idx[s * L:s * L + k] = pt[a:b] - self.pt_off[s]
            self.uv[s * L:s * L + k] = uv[a:b]
            self.weight[s * L:s * L + k] = w[a:b]
            # padding keeps local pt ids sorted and in-range; weight 0
            self.ptl_idx[s * L + k:(s + 1) * L] = max(self.m_pts[s] - 1, 0)

    def shard(self, s, device, dtype=torch.float32):
        """Shard s's observations (local point ids) as tensors on device."""
        sl = slice(s * self.L, (s + 1) * self.L)
        return bundle.observations_on(bundle.BAObservations(
            self.cam_idx[sl], self.ptl_idx[sl], self.uv[sl],
            self.weight[sl]), device, dtype)


def make_pointlocal_ba(mesh, part, n_pt, K, dist, cg_iters=40, cg_tol=1e-3):
    """(jac_fn, solve_fn, cost_fn) of bundle.lm_loop over a point-boundary
    partition on mesh: each local shard holds its observations (local
    point ids) on its device, and sees the replicated cameras and its
    slice [pt_off, pt_off + M) of the replicated points."""
    M, n_pt_pad = part.M, part.n_pt_pad
    shards = [dict(obs=part.shard(s, dev), off=int(part.pt_off[s]),
                   m=int(part.m_pts[s]), K=bundle._on(K, dev, torch.float32),
                   dist=bundle._on(dist, dev, torch.float32))
              for s, dev in zip(mesh.local, mesh.devices)]

    def local_pts(pts, sh, dev):
        pad = torch.cat([pts, pts.new_zeros((n_pt_pad - n_pt, 3))]) \
            if n_pt_pad > n_pt else pts
        return pad[sh["off"]:sh["off"] + M].to(dev)

    def jac_fn(cams, pts):
        def run(ctx, sh):
            return bundle.lm_jacobians(
                cams.to(ctx.device), local_pts(pts, sh, ctx.device),
                sh["obs"], sh["K"], sh["dist"], cams.shape[0], M,
                reduce=ctx.reduce())
        return mesh.map(run, shards)

    def solve_fn(jacs, lam):
        def run(ctx, item):
            jac, sh = item
            dc, dp, pred = bundle.lm_solve(
                jac, sh["obs"].cam_idx, sh["obs"].pt_idx, lam,
                cg_iters=cg_iters, cg_tol=cg_tol, reduce=ctx.reduce())
            # Δpts: each shard's real rows into its slice of a zero
            # buffer, summed (exact: one term per row)
            full = dp.new_zeros((n_pt_pad, 3))
            full[sh["off"]:sh["off"] + sh["m"]] = dp[:sh["m"]]
            full, = ctx.sum(full)
            return dc, full[:n_pt], pred
        dc, dp, pred = mesh.map(run, list(zip(jacs, shards)))[0]
        return dc.to(mesh.home), dp.to(mesh.home), pred.to(mesh.home)

    def cost_fn(cams, pts):
        def run(ctx, sh):
            r = bundle._residuals(cams.to(ctx.device),
                                  local_pts(pts, sh, ctx.device), sh["obs"],
                                  sh["K"], sh["dist"])
            a = r.abs()
            cost, asum, wsum = ctx.sum(0.5 * (r * r).sum(), a.sum(),
                                       sh["obs"].weight.sum())
            return cost, asum / (2.0 * wsum.clamp_min(1.0)), ctx.max(a.max())
        return tuple(x.to(mesh.home) for x in mesh.map(run, shards)[0])

    return jac_fn, solve_fn, cost_fn


def solve_sharded(cams0, pts0, obs, K, dist, mesh,
                  config: bundle.BAConfig = bundle.BAConfig(), verbose=True,
                  log_fn=print):
    """bundle.solve's LM loop (bundle.lm_loop) with every inner step
    sharded over mesh: the point-local partition, one (n_cam, 7) sum a CG
    iteration. f32, cameras and points on the mesh's home device, the
    position box around cams0. Every rank of a ProcessMesh calls it with
    the same problem; each returns the same BAResult (numpy)."""
    n_pt = bundle._np(pts0).shape[0]
    part = PointPartition(obs, n_pt, mesh.shards)
    jac_fn, solve_fn, cost_fn = make_pointlocal_ba(
        mesh, part, n_pt, K, dist, cg_iters=config.cg_iters,
        cg_tol=config.cg_tol)
    cams = bundle._on(cams0, mesh.home, torch.float32)
    pts = bundle._on(pts0, mesh.home, torch.float32)
    return bundle.lm_loop(cams, pts, cams[:, :3], config, jac_fn, solve_fn,
                          cost_fn, verbose=verbose, log_fn=log_fn)


def sharded_detect(mesh, per_octave, n_octaves):
    """features/sift.py's batched detector with its image axis split over
    the mesh: each shard detects its own images, and the outputs are
    gathered. Returns fn(imgs (B, H, W) on the home device, B a multiple
    of the shard count) → (kp, meta, desc, valid) on the home device."""
    from ..features.sift import _detect_batch

    def fn(imgs):
        n = imgs.shape[0]
        items = [imgs[slice(*mesh.shard_of(n, i))] for i in mesh.local]

        def run(ctx, x):
            return _detect_batch(x.to(ctx.device), per_octave, n_octaves)

        outs = mesh.map(run, items)
        return tuple(mesh.gather([o[k] for o in outs], n) for k in range(4))

    return fn


def sharded_match_pair_batch(mesh, ratio=0.75, thresh=3.0, **kwargs):
    """match/matcher.py's match_pair_batch with its pair axis split over
    the mesh: each shard matches B / R pairs, no communication, the
    outputs gathered. Returns fn(desc_a, desc_b, uv_a, uv_b, n_a, n_b, K,
    pick) → (best_j, ok) on the home device. RANSAC draws pair b's samples
    from ransac.PairDraws(0) keyed by b, its index in the whole batch,
    and pick (B, n_hyp, k) splits with the pairs, so either way the
    result is the unsharded call's with the same draws."""
    from ..match.matcher import match_pair_batch
    from ..ops.ransac import PairDraws

    draws = PairDraws(0)

    def fn(desc_a, desc_b, uv_a, uv_b, n_a, n_b, K=None, pick=None):
        n = desc_a.shape[0]
        items = []
        for i in mesh.local:
            a, b = mesh.shard_of(n, i)
            items.append([None if x is None else x[a:b]
                          for x in (desc_a, desc_b, uv_a, uv_b, n_a, n_b,
                                    pick)] + [torch.arange(a, b)])

        def run(ctx, args):
            args = [None if x is None else x.to(ctx.device) for x in args]
            return match_pair_batch(
                *args[:6], draws.keyed(args[7]), ratio=ratio, thresh=thresh,
                pick=args[6], K=None if K is None else K.to(ctx.device),
                **kwargs)

        outs = mesh.map(run, items)
        return tuple(mesh.gather([o[k] for o in outs], n) for k in range(2))

    return fn
