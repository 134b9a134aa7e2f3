"""One-command checkpoint/numerics fidelity acceptance of the port.

Counterpart of ``ideepcolor_tpu/apps/fidelity.py``. ``python -m
ideepcolor_tpu_torch fidelity`` runs, for each artifact, the port's test
that holds the same property against the JAX package on the same inputs
(the checkpoint wire forms, the Caffe and SIGGRAPH forwards, the demos) and
prints ONE line per artifact: ``PASS``, ``FAIL``, or ``SKIP`` with pytest's
reason when every test of the target skipped. The exit code is nonzero only
when an artifact failed; a target that collects nothing (pytest exit 5)
fails.

The JAX runner's golden-frame artifacts (``goldens-64``, ``goldens-256``)
have no counterpart here: their frames need the reference checkout, which
the port's tests do not use.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

# artifact name -> (pytest target, what it proves)
ARTIFACTS = (
    ("caffemodel-wire-v1v2",
     "tests/test_torch_caffemodel_io.py::"
     "test_the_same_bytes_parse_to_equal_arrays_in_both_packages",
     "modern and legacy (V1) caffemodel wire forms parse to JAX's arrays"),
    ("caffemodel-main-256",
     "tests/test_torch_caffe_api.py::test_main_session_matches_jax",
     "main net from a .caffemodel / .npz: session frames vs JAX"),
    ("caffemodel-dist-256",
     "tests/test_torch_caffe_api.py::test_dist_session_matches_jax",
     "dist net (hypercolumn head, upsamplers): maps and frames vs JAX"),
    ("caffemodel-global-256",
     "tests/test_torch_caffe_api.py::test_global_session_matches_jax",
     "global-hints net (314-ch MLP, conv4 fusion) vs JAX"),
    ("pth-modern",
     "tests/test_torch_siggraph.py::test_loader_takes_both_layouts_and_pth",
     ".pth state dict and both .npz layouts load to the same net"),
    ("pth-legacy-pre04",
     "tests/test_torch_siggraph.py::test_legacy_pre04_pth_loads_like_jax",
     "pre-0.4 state-dict layout (no num_batches_tracked, legacy pickle)"),
    ("notebooks",
     "tests/test_torch_caffe_api.py::test_demos_run_on_arrays",
     "both reference notebooks' sessions (the demos) vs JAX"),
)

_SKIP_REASON = re.compile(r"^SKIPPED \[\d+\] [^:]+(?::\d+)?: (.*)$", re.M)
_COUNTS = re.compile(r"(\d+) (passed|failed|skipped|error|errors)")


def _status(returncode: int, stdout: str) -> tuple[str, str]:
    """(PASS | FAIL | SKIP, the reason for a SKIP) of one pytest run."""
    if returncode != 0:          # 5 = nothing collected: a broken target
        return "FAIL", ""
    counts = {kind: int(n) for n, kind in _COUNTS.findall(stdout)}
    if counts.get("skipped") and not counts.get("passed"):
        reasons = _SKIP_REASON.findall(stdout)
        return "SKIP", reasons[0] if reasons else "every test skipped"
    return "PASS", ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default="",
                    help="comma-separated artifact names (default: all)")
    ap.add_argument("--list", action="store_true",
                    help="list artifacts and exit")
    args = ap.parse_args(argv)
    if args.list:
        for name, _t, what in ARTIFACTS:
            print(f"{name:<22} {what}")
        return 0
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if not os.path.isdir(os.path.join(repo, "tests")):
        print("FAIL  (tests/ not found — fidelity runs from a source "
              "checkout)", file=sys.stderr)
        return 2
    print("# fidelity acceptance of the port against the JAX package "
          "(seeded and bundled weights)")
    only = {s.strip() for s in args.only.split(",") if s.strip()}
    failed = 0
    for name, target, what in ARTIFACTS:
        if only and name not in only:
            continue
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "pytest", target, "-q", "-rs",
             "--no-header", "-x"],
            cwd=repo, capture_output=True, text=True)
        dt = time.time() - t0
        status, reason = _status(r.returncode, r.stdout or "")
        print(f"{status:<5} {name:<22} {dt:6.1f}s  ({what})")
        if status == "SKIP":
            print(f"      {reason[:110]}")
        elif status == "FAIL":
            failed += 1
            tail = (r.stdout or r.stderr).strip().splitlines()[-3:]
            for ln in tail:
                print(f"      {ln[:110]}")
    print(f"# fidelity: {'ALL PASS' if not failed else f'{failed} FAILED'}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
