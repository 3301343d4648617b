"""Device time of the banded FD kernel's dense pass, from a profiler trace.

Runs the ``bench.py`` configuration (vmapped batch of 128, 1 yr on the full
1.58M-bin grid) on one GPU: compiles and warms the batch generator, traces
a few calls with ``jax.profiler``, and reduces the trace to

* the device time per batch call (union of the module's kernel intervals),
* the device time of the dense pass per call: kernels whose HLO op carries
  the ``summation_fd.DENSE_PASS_SCOPE`` name scope (a fusion counts as dense
  when any op fused into it does),
* the host wall time per call.

Run from the repository root on a machine with one GPU:

    python tools/trace_dense_pass.py [--out chiprun_out/trace_dense_pass]

The summary is printed as one JSON line and written beside the trace.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
import time

_INSTR = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = ")
_COMP = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) \(.*\{\s*$")
_CALLS = re.compile(r"(?:calls|to_apply|body|condition|branch_computations)=\{?%?([\w.\-]+)")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def kernel_key(name: str) -> str:
    """HLO instruction name as the GPU backend names its kernel."""
    return re.sub(r"[.\-]", "_", name)


def dense_hlo_ops(hlo_text: str, scope: str) -> set[str]:
    """Names of the HLO instructions of a compiled module that belong to
    the named scope ``scope``, directly or through a computation they call
    (fusions, loops)."""
    in_scope: set[str] = set()
    comp_in_scope: dict[str, bool] = {}
    calls: dict[str, list[str]] = {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
            comp_in_scope.setdefault(comp, False)
            continue
        m = _INSTR.match(line)
        if not m or comp is None:
            continue
        name = m.group(1)
        op = _OP_NAME.search(line)
        # the scope is a path element, "vmap(scope)" under a vmap
        if op and re.search(rf"(?:^|[/(]){re.escape(scope)}(?:[)/]|$)", op.group(1)):
            in_scope.add(name)
            comp_in_scope[comp] = True
        calls[name] = _CALLS.findall(line)

    return in_scope | {
        n for n, cs in calls.items() if any(comp_in_scope.get(c) for c in cs)
    }


def reduce_trace(xplane_path: str, module: str, dense_ops: set[str],
                 plane_prefix: str = "/device:GPU",
                 line_prefix: str = "Stream") -> dict:
    """Device busy time and dense-pass time of ``module`` in a trace.

    Kernel events are taken from the lines named ``line_prefix*`` of the
    planes named ``plane_prefix*``; an event belongs to the module when its
    ``hlo_module`` stat names it, and to the dense pass when its ``hlo_op``
    stat or its kernel name is one of ``dense_ops`` (inside a CUDA graph
    the ``hlo_op`` stat names the command buffer, not the fusion). Times
    are in seconds; ``events`` lists (kernel, hlo_op, duration_ns).
    """
    dense_keys = {kernel_key(n) for n in dense_ops}
    from jax.profiler import ProfileData

    busy, dense, n_events = [], 0.0, 0
    lines_seen, events = [], []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            lines_seen.append(line.name)
            if not line.name.startswith(line_prefix):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                if stats.get("hlo_module") != module:
                    continue
                n_events += 1
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                events.append((ev.name, str(stats.get("hlo_op")), ev.duration_ns))
                if (stats.get("hlo_op") in dense_ops
                        or kernel_key(ev.name) in dense_keys):
                    dense += ev.duration_ns * 1e-9
    total = 0.0
    end = None
    for lo, hi in sorted(busy):  # union of the kernel intervals
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return {"device_busy_s": total * 1e-9, "dense_pass_s": dense,
            "kernel_events": n_events, "lines": lines_seen, "events": events}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/trace_dense_pass")
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench
    import jax
    from emri_frequencydomainwaveforms_tpu.models.summation_fd import DENSE_PASS_SCOPE
    from emri_frequencydomainwaveforms_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    device = bench.require_gpu()
    b = bench.setup()
    batch_fn = jax.jit(jax.vmap(b.gen))
    compiled = batch_fn.lower(*b.batch).compile()
    hlo = compiled.as_text()
    module = re.search(r"^HloModule (\S+?),", hlo, re.M).group(1)
    dense_ops = dense_hlo_ops(hlo, DENSE_PASS_SCOPE)
    jax.block_until_ready(compiled(*b.batch))  # warm

    os.makedirs(args.out, exist_ok=True)
    walls = []
    with jax.profiler.trace(args.out):
        for _ in range(args.calls):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*b.batch))
            walls.append(time.perf_counter() - t0)
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path, module, dense_ops)
    summary = {
        "device": device,
        "batch": bench.BATCH,
        "calls": args.calls,
        "host_wall_per_call_s": walls,
        "device_busy_per_call_s": red["device_busy_s"] / args.calls,
        "dense_pass_per_call_s": red["dense_pass_s"] / args.calls,
        "dense_share_of_busy": red["dense_pass_s"] / max(red["device_busy_s"], 1e-30),
        "kernel_events": red["kernel_events"],
        "dense_hlo_ops": len(dense_ops),
        "trace_lines": sorted(set(red["lines"])),
        "module": module,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    # the raw material of the reduction, for checking it by hand
    with gzip.open(os.path.join(args.out, "hlo.txt.gz"), "wt") as fh:
        fh.write(hlo)
    with gzip.open(os.path.join(args.out, "events.json.gz"), "wt") as fh:
        json.dump({"dense_ops": sorted(dense_ops), "events": red["events"]}, fh)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
