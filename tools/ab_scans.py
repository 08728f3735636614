"""Time the port's scan kernels of one checkout on the card, for A/B runs.

Imports ``repro_torch`` from ``<checkout>/src`` (building that checkout's
kernels into its own ``build/``), times ``mamba_scan_bwd`` and
``slstm_scan_bwd`` at the shapes of ``chip_smoke.py``'s
recurrent_bwd_kernels phase and the two forward scans at the serve prompt
(1, 500), and prints one JSON line: CUDA-event medians of 30 launches, L2
flushed before each, as ``chip_smoke.Timer`` takes them.  The backward
shapes' cotangents of the final state are nonzero.

To compare a parent commit with the working tree in one call on one card,
unpack the parent into an ignored directory and run the trees in turns::

    git archive HEAD | tar -x -C build/ab/parent
    for t in build/ab/parent . . build/ab/parent; do
        python3 tools/ab_scans.py "$t"; done

Needs a CUDA card and ``nvcc``.
"""
import json
import math
import statistics
import sys
from pathlib import Path


def main() -> int:
    """Time the kernels of the checkout named by ``sys.argv[1]``."""
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import slstm as sl

    if not torch.cuda.is_available():
        print("ab_scans: no CUDA card visible", file=sys.stderr)
        return 1
    assert build.CSRC.is_relative_to(root), build.CSRC
    build.load_library()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def timed(fn, reps=30):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(200_000_000)        # covers the enqueue
        for start, end in events:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    out = {"checkout": str(root), "device": torch.cuda.get_device_name(0)}
    for B, S, d, N in ((2, 4096, 16384, 16), (1, 500, 16384, 16),
                       (2, 100, 1000, 8), (1, 77, 2048, 16), (1, 45, 200, 8)):
        dt = F.softplus(rand(B, S, d) - 4.6)
        a = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").repeat(d, 1)
        args = (dt, rand(B, S, d), rand(B, S, N), rand(B, S, N), a)
        dy, dh = rand(B, S, d), rand(B, d, N)
        h_ckpt = torch.empty(ms.ckpt_shape(dt, a), device="cuda")
        ms.mamba_scan(*args, h_ckpt=h_ckpt)
        out[f"mamba_scan_bwd {B},{S},{d},{N}"] = timed(
            lambda: ms.mamba_scan_bwd(*args, h_ckpt, dy, dh))
        if (B, S) == (1, 500):
            out["mamba_scan 1,500"] = timed(lambda: ms.mamba_scan(*args))
    for B, S, d, H in ((4, 4096, 768, 4), (1, 500, 768, 4), (2, 40, 392, 2),
                       (3, 33, 96, 2), (2, 64, 768, 4)):
        dh = d // H
        gx = rand(B, S, 4 * d)
        r = rand(H, dh, 4 * dh) / math.sqrt(dh)
        saved = sl.residuals(gx)
        h, _ = sl.slstm_scan(gx, r, saved)
        dy = rand(B, S, d)
        dfin = tuple(rand(B, d) for _ in range(4))
        out[f"slstm_scan_bwd {B},{S},{d},{H}"] = timed(
            lambda: sl.slstm_scan_bwd(r, h, saved, dy, dfin))
        if (B, S) == (1, 500):
            out["slstm_scan 1,500"] = timed(lambda: sl.slstm_scan(gx, r))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
