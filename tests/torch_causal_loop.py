"""Failure rates of a causal checker case (tests/causal_core.py) on both
packages, measured side by side under the same load.

Starts ``--procs`` processes for each package at once; each runs the
reference case ``--runs`` times from tests/torch_refexec.py's loaders
(the port on the CPU, fresh data directories every run) and counts the
runs whose checker failed (an AssertionError: causal floor, downward
closure, session monotonicity) apart from any other error.  Prints one
JSON line with both packages' counts and the failures' first lines.

    python tests/torch_causal_loop.py --runs 8 --procs 3
    python tests/torch_causal_loop.py --case \\
        tests/cluster/test_causal_resize.py::test_causal_visibility_through_resize

``--root`` runs the copy of the repo at that path (for example a
``git archive`` of another commit) with this script's own driver.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

CASE = ("tests/cluster/test_causal_federation.py::"
        "test_causal_visibility_across_member_restart")


def child(root, pkg, runs, case):
    """One process: ``runs`` runs of ``case`` on ``pkg``; prints its
    counts as one JSON line."""
    sys.path[:0] = [os.path.join(root, "tests"), root]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pytest
    import torch

    import torch_refexec as rx
    from antidote_tpu.obs.spans import tracer as jtracer
    from antidote_tpu_torch.cluster import node as tnode
    from antidote_tpu_torch.interdc import dc as tdc
    from antidote_tpu_torch.obs.spans import tracer as ttracer

    def cpu(device=None):
        return torch.device("cpu" if device is None else device)

    tnode.resolve_device = tdc.resolve_device = cpu
    jtracer.sample_rate = ttracer.sample_rate = 0.0
    rel, qual = case.split("::")
    params = {}
    if qual.endswith("]"):
        qual, p = qual[:-1].split("[")
        params = {"placement": p}
    loader = rx.Loader(port=pkg == "port")
    out = {"pkg": pkg, "runs": runs, "checker": [], "other": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(runs):
            mp = pytest.MonkeyPatch()
            try:
                rx.run_case(loader.module(rel), rel, qual, params,
                            pathlib.Path(tempfile.mkdtemp(dir=tmp)), mp)
            except AssertionError as e:
                out["checker"].append(str(e).split("\n")[0][:200])
            except Exception as e:  # noqa: BLE001 — counted apart
                out["other"].append(f"{type(e).__name__}: {e}"[:200])
            finally:
                mp.undo()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--case", default=CASE)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--child", nargs=2, metavar=("PKG", "RUNS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.root, args.child[0], int(args.child[1]), args.case)
        return
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--root", args.root,
         "--case", args.case, "--child", pkg, str(args.runs)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=args.root)
        for _ in range(args.procs) for pkg in ("jax", "port")]
    total = {pkg: {"runs": 0, "checker": [], "other": []}
             for pkg in ("jax", "port")}
    for p in procs:
        out, _ = p.communicate()
        got = json.loads(out.strip().splitlines()[-1])
        t = total[got["pkg"]]
        t["runs"] += got["runs"]
        t["checker"] += got["checker"]
        t["other"] += got["other"]
    print(json.dumps({"case": args.case, "root": args.root,
                      "procs_a_package": args.procs,
                      "seconds": round(time.time() - t0), **total}))


if __name__ == "__main__":
    main()
