"""On-card probes of the 2-NN kernels: the counterparts of the TPU dev
probes P1–P6 under ``scripts_dev/``; and K2's yardstick.

The JAX package keeps these kernels inline in its dev scripts; the port
keeps them here, so that the scripts in ``scripts_torch/``, the tests and
``chip_smoke.py`` import one copy:

- ``knn_stages`` — K1 cut down stage by stage and swept over block tiles
  (P3 ``knn_culprit_bisect``, P4 ``knn_stage_cost``, P6
  ``knn_overhead_sweep``), ``csrc/knn_probe.cu``;
- ``mma`` — the tensor-core yardsticks: the descriptor product with a row
  sum (P5 ``matmul_shape_probe``) and the one-hot gather (P1
  ``epilogue_dot_probe``), ``csrc/mma_probe.cu``;
- ``fused`` — K1 and K4 in one launch, parts switched off (P2
  ``fused_vmem_probe``), ``csrc/knn_fused_probe.cu``;
- ``blur`` — K2's first body, the yardstick its register-window body is
  timed against (no TPU probe of its own), ``csrc/gauss_blur.cu``.

Each module holds its kernels' wrappers and their plain PyTorch versions;
a wrapper takes the plain version for a CPU tensor, launches its kernel
for a CUDA tensor, and raises on any other device.
"""

import time

import numpy as np
import torch


def time_ms(fn, device, reps=5, warmup=1):
    """Median milliseconds of fn(): CUDA events on a CUDA device (device
    time of the work fn enqueues), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def device_kernels(fn, reps=20):
    """{CUDA kernel name: device milliseconds per call of fn}, from
    torch.profiler over reps calls: every kernel fn launches, each timed
    per launch it recorded (a profile may miss some) times its launches a
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    # late in a long process on the card (a whole chip_smoke.py run) most
    # profiles of a short call come back without device events, whatever
    # the card's free memory, and one taken just after
    # torch.cuda.empty_cache() mostly does not (scripts_torch/
    # profiler_bisect.py): up to three tries, the caching allocator
    # emptied before each retry
    for attempt in range(3):
        if attempt:
            torch.cuda.empty_cache()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = {e.key: e.self_device_time_total / e.count / 1e3
              * max(1, round(e.count / reps))
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0}
        if ms:
            return ms
    raise AssertionError("the profiler saw no device time")


def device_ms(fn, kernel=None, reps=20):
    """Device time per call of fn from torch.profiler: the CUDA kernels
    whose name contains kernel (all of fn's kernels when None), summed.
    For kernels of tens of microseconds or less, where CUDA events around
    one call would time the wrapper's host work."""
    ms = [t for k, t in device_kernels(fn, reps).items()
          if kernel is None or kernel in k]
    if not ms:
        raise AssertionError(f"the profiler saw no device time for {kernel}")
    return sum(ms)


def script_inputs(pairs, n, device, seed=0):
    """The TPU probes' inputs: numpy default_rng(seed) uint8 descriptors
    a8, b8 (pairs, n, 128). Returns (a, b) as int8 (value − 128) and
    (a, b, na2, nb2) as bf16 holding the values 0..255 with their f32
    squared norms, on device."""
    rng = np.random.default_rng(seed)
    a8 = rng.integers(0, 256, (pairs, n, 128)).astype(np.uint8)
    b8 = rng.integers(0, 256, (pairs, n, 128)).astype(np.uint8)
    i8 = [torch.from_numpy((x.astype(np.int16) - 128).astype(np.int8))
          .to(device) for x in (a8, b8)]
    f = [torch.from_numpy(x).to(device).float() for x in (a8, b8)]
    return i8, (f[0].bfloat16(), f[1].bfloat16(), (f[0] * f[0]).sum(-1),
                (f[1] * f[1]).sum(-1))


def device_line(device):
    """What the numbers of a probe script were measured on."""
    if torch.device(device).type == "cuda":
        return (f"device: {torch.cuda.get_device_name(device)}, torch "
                f"{torch.__version__}, CUDA {torch.version.cuda}; CUDA-event "
                "device times")
    return "device: cpu (plain versions; host-clock times, no device metric)"


def check_device(tensors, name):
    """The device of tensors (all on one); raises unless CPU or CUDA."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def check_launchable(tensors, name, align=16):
    for t in tensors:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"{align}-byte aligned")
