"""Time chip_smoke's serve, serve_mesh (+ serve_tp) and serve_lifecycle
phases of one checkout on the card, for A/B runs.

Imports ``chip_smoke`` and ``repro_torch`` from ``<checkout>`` (building
that checkout's kernels into its own ``build/``), runs the phases as
``chip_smoke.main`` runs them -- serve_tp's ranks started inside
serve_mesh's window of ranks where the checkout has serve_tp -- with
every check they make, and prints one line ``AB <checkout> {json}``: each
phase's host seconds (``serve_mesh+serve_tp`` from serve_mesh's start to
serve_tp's end).

To compare a parent commit with the working tree in one call on one card,
unpack the parent into an ignored directory and run the trees in turns::

    git archive HEAD | tar -x -C build/ab/parent
    for t in build/ab/parent . . build/ab/parent; do
        python3 tools/ab_serve_phases.py "$t"; done

Needs a CUDA card, ``nvcc`` and ``triton``.
"""
import json
import os
import sys
import tempfile
import time


def main(root: str) -> int:
    """Run and time the phases of the checkout at ``root``."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs

    torch.cuda.set_device(0)
    cs.phase_card(torch)
    cs.phase_build(torch)
    secs = {}
    t0 = time.perf_counter()
    _, figures, model = cs.phase_serve(torch)
    cs.release(torch)
    secs["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if hasattr(cs, "serve_tp_start"):
        jobs = {}
        cs.phase_serve_mesh(
            torch, model, figures, start_with=lambda: jobs.update(
                cs.serve_tp_start(tempfile.mkdtemp(prefix="ab_serve_tp_"))))
        cs.release(torch)
        secs["serve_mesh"] = time.perf_counter() - t0
        cs.phase_serve_tp(torch, model, figures, jobs=jobs)
    else:
        cs.phase_serve_mesh(torch, model, figures)
        secs["serve_mesh"] = time.perf_counter() - t0
    del model
    cs.release(torch)
    secs["serve_mesh+serve_tp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.phase_serve_lifecycle(torch)
    cs.release(torch)
    secs["serve_lifecycle"] = time.perf_counter() - t0
    print("AB", root, json.dumps(secs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "."))
