"""Where, in one long process on the card, torch.profiler stops seeing
device events, and whether the card's free memory decides it. Needs a
card:

    python3 scripts_torch/profiler_bisect.py run [--no-wg]
    python3 scripts_torch/profiler_bisect.py fill

run: chip_smoke.py's phases 1-14 in its order in this one process, then
phase 15's parts in its order (the probes' inputs, compare_stages, P3/P4,
P6, P5, P1, P2). After each phase, and after each "[P6]" or "[probes]"
line of phase 15, one canary profile: a 2048² f32 product five times
under torch.profiler, one try. Each canary prints a line "[canary] {json}"
with the step, the device events the profile saw, the card's free memory
and the caching allocator's reserved and allocated MiB. After an empty
canary it empties the caching allocator (torch.cuda.empty_cache) and
profiles again ("... after empty_cache"). A part of phase 15 that raises
is printed and the run goes on. --no-wg launches none of the wgmma probe
kernels: P6's wgmma tiles run the mma.sync body's K1 tile instead (the
same minima), P2 is left out.

fill: a fresh process; its first profile, the canary, with the card's
free memory cut to 16 MiB by one filler tensor, then one with the filler
freed.
"""

import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from imageanalysis_tpu_torch.probes import knn_stages  # noqa: E402

FILL_HEADROOMS_MIB = (16, None)
_x = []


def canary(step, retry=True):
    """One profile of five 2048² products: prints and returns the device
    events it saw; on none, empty_cache and one more (retry)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    if not _x:
        _x.append(torch.randn(2048, 2048, device="cuda"))
        _x[0] @ _x[0]
    x = _x[0]
    torch.cuda.synchronize()
    free, _ = torch.cuda.mem_get_info()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            x @ x
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0)
    print("[canary] " + json.dumps({
        "step": step, "device_events": n, "free_mib": free >> 20,
        "reserved_mib": torch.cuda.memory_reserved() >> 20,
        "allocated_mib": torch.cuda.memory_allocated() >> 20}), flush=True)
    if n == 0 and retry:
        torch.cuda.empty_cache()
        canary(f"{step} after empty_cache", retry=False)
    return n


def phases_1_14():
    """chip_smoke.main's phases 1-14, a canary after each; returns what
    main keeps alive into phase 15."""
    smi = cs.device_info()
    cs.build()
    canary("2 (build)")
    keep = [smi]
    for name, fn in (("3 (K2)", cs.check_blur), ("4 (K1)", cs.check_knn),
                     ("5 (K3)", cs.check_wide),
                     ("4-5 (256)", cs.check_knn_256),
                     ("11 (K4)", cs.check_epilogue)):
        keep.append(fn())
        canary(name)
    bench_pps = cs.bench_workload()
    canary("6 (bench)")
    slice_launches, m, dets = cs.run_slice()
    canary("7 (slice)")
    with tempfile.TemporaryDirectory() as root:
        smart_launches, smart_result, proj, state, p8 = cs.run_smart_slice(
            m, dets, root, False)
        canary("8 (smart)")
        try:
            cs.run_fused_bench(bench_pps)
            cs.run_fused_smart(m, dets, root, smart_result)
        finally:
            os.environ.pop(cs.FUSED, None)
        canary("12 (fused)")
        cs.run_steps_3b_4(proj, state, m, root, False)
        canary("13 (Steps 3b-4)")
        del m, dets, proj
        keep += [slice_launches, smart_launches, smart_result, state, p8,
                 cs.run_repetitive(root)]
        canary("9 (repetitive)")
    keep.append(cs.run_wide_store())
    canary("10 (wide store)")
    keep.append(cs.run_mission_ba())
    canary("14 (BA)")
    return keep


def phase_15(no_wg):
    """run_probes' parts in its order, each caught and printed."""
    log = cs.log

    def log_and_canary(*a):
        log(*a)
        s = " ".join(map(str, a))
        if s.startswith(("[P6]", "[probes]")):
            canary("15 " + s[:60])
    cs.log = log_and_canary
    if no_wg:
        knn_stages.wg_row_min_raw = (
            lambda a, b, tile=None: knn_stages.tc_row_min_raw(a, b))
        knn_stages.wg_row_min_blocks = lambda dtype, tile: 0
    a, b, uv_b, fargs = cs.probe_inputs()
    canary("15 inputs")
    bt = b[0].t()
    int_mm = cs.time_ms(lambda: torch._int_mm(a.reshape(-1, 128), bt), 3)
    del bt
    bmm = cs.time_ms(lambda: torch.bmm(fargs[0], fargs[1].transpose(1, 2)),
                     3)
    parts = [("compare_stages", lambda: cs.compare_stages(a, b, fargs)),
             ("P3/P4", lambda: cs.run_anatomy(
                 a, b, fargs, {"int8": int_mm, "bf16": bmm})),
             ("P6", lambda: cs.run_tile_sweep(a, b, fargs)),
             ("P5", lambda: cs.run_mma(int_mm)),
             ("P1", cs.run_gather)]
    if not no_wg:
        parts.append(("P2", lambda: cs.run_fused(a, b, uv_b)))
    for name, fn in parts:
        try:
            fn()
            print(f"[bisect] {name} done", flush=True)
        except Exception as e:      # the bisect goes on to the next part
            print(f"[bisect] {name} raised {type(e).__name__}: {e}",
                  flush=True)
        canary(f"15 after {name}")


def fill():
    _x.append(torch.randn(2048, 2048, device="cuda"))
    _x[0] @ _x[0]                   # cuBLAS's workspace, before any filler
    for mib in FILL_HEADROOMS_MIB:
        filler = None
        if mib is not None:
            free, _ = torch.cuda.mem_get_info()
            filler = torch.empty(free - (mib << 20), dtype=torch.uint8,
                                 device="cuda")
        canary(f"fill: headroom {mib} MiB", retry=False)
        del filler
        torch.cuda.empty_cache()


def main():
    if sys.argv[1:2] == ["fill"]:
        fill()
        return 0
    if sys.argv[1:2] != ["run"]:
        raise SystemExit(__doc__)
    no_wg = "--no-wg" in sys.argv[2:]
    keep = phases_1_14()
    phase_15(no_wg)
    del keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
