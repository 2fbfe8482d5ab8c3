"""Device-time breakdown of the headline production sweep from a trace.

    python benchmarks/sweep_profile.py [--chains 256] [--sweeps 50]
                                       [--out PATH.json]

Compiles the scanned production sweep (K=3, P=8, M=4, N=100, L=100,
collapsed Z + gauge moves) vmapped over the chains, runs it once untraced,
then traces one more call with ``jax.profiler`` and reduces the device
events of that window to:

  * busy time (union of device intervals) and the idle share of the window;
  * device time of the joint Phi draw (``jax.named_scope`` in
    ``gibbs._joint_blocked_draw``) and its share of busy time;
  * device time per Python function that emitted each kernel's HLO op,
    read from the compiled HLO's stack-frame tables.

Kernels that XLA launches inside a CUDA command buffer report their HLO
op as ``command_buffer``; for a complete attribution run with
``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` (idle share and rate then
describe that configuration, not the default one).

Needs a GPU; it refuses to run on any other backend.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPE = "joint_precision_draw"

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{([^}]*)\}")
_META = re.compile(r'(\w+)=(?:"([^"]*)"|(\d+))')


def _norm(name):
    return re.sub(r"[.\-]", "_", name)


def hlo_metadata(hlo_text):
    """normalized instruction name -> {op_name, stack_frame_id}."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            meta = {k: (s if s else int(n))
                    for k, s, n in _META.findall(m.group(2))}
            out[_norm(m.group(1))] = meta
    return out


def _table(hlo_text, name):
    """id -> text of one of the HLO module's trailing tables."""
    i = hlo_text.find("\n" + name + "\n")
    if i < 0:
        return {}
    body = hlo_text[i + len(name) + 2:].split("\n\n", 1)[0]
    return {int(k): v for k, v in (ln.split(" ", 1)
                                   for ln in body.splitlines() if ln)}


def frame_functions(hlo_text):
    """stack_frame_id -> 'file.py:function' of the frame's own location
    (the Python function whose line emitted the op)."""
    files = _table(hlo_text, "FileNames")
    funcs = _table(hlo_text, "FunctionNames")
    locs = _table(hlo_text, "FileLocations")
    out = {}
    for fid, txt in _table(hlo_text, "StackFrames").items():
        loc = dict(re.findall(r"(\w+)=(\d+)", locs.get(
            int(dict(re.findall(r"(\w+)=(\d+)", txt))["file_location_id"]),
            "")))
        f = files.get(int(loc.get("file_name_id", 0)), '"?"').strip('"')
        fn = funcs.get(int(loc.get("function_name_id", 0)), '"?"').strip('"')
        out[fid] = f"{os.path.basename(f)}:{fn}"
    return out


def _union_ns(intervals):
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(xspace_path, hlo_text):
    """Device-time summary of one traced window (see module docstring)."""
    import jax

    prof = jax.profiler.ProfileData.from_file(xspace_path)
    meta = hlo_metadata(hlo_text)
    frames = frame_functions(hlo_text)
    lines_seen, events = {}, []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen[f"{plane.name}|{line.name}"] = len(evs)
            if not line.name.startswith("Stream"):
                continue
            for ev in evs:
                events.append((ev, dict(ev.stats)))
    if not events:
        raise RuntimeError(f"no GPU kernel events; lines: {lines_seen}")
    start = min(ev.start_ns for ev, _ in events)
    end = max(ev.end_ns for ev, _ in events)
    busy = _union_ns([(ev.start_ns, ev.end_ns) for ev, _ in events])
    joint, by_fn, by_kernel, unmatched = 0.0, {}, {}, 0
    memcpy = {}
    for ev, st in events:
        if ev.name.startswith("Memcpy"):
            memcpy[ev.name] = memcpy.get(ev.name, 0) + 1
        op = str(st.get("hlo_op", ev.name))
        md = meta.get(_norm(op), {})
        if not md:
            unmatched += 1
        op_name = str(st.get("tf_op", "")) + "|" + md.get("op_name", "")
        dur = ev.duration_ns
        if SCOPE in op_name:
            joint += dur
        fn = frames.get(md.get("stack_frame_id"), "<no source>")
        by_fn[fn] = by_fn.get(fn, 0.0) + dur
        k = by_kernel.setdefault(ev.name, [0.0, 0, fn, SCOPE in op_name])
        k[0] += dur
        k[1] += 1
    kernel_sum = sum(by_fn.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "window_ns": end - start, "busy_ns": busy,
        "idle_share": 1.0 - busy / (end - start),
        "kernel_events": len(events), "kernel_ns_sum": kernel_sum,
        "events_without_hlo_metadata": unmatched,
        "memcpy_events": memcpy,
        "joint_draw_ns": joint, "joint_draw_share_of_kernel_time":
            joint / kernel_sum,
        "by_function_ns": dict(sorted(by_fn.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n, "ns": v[0], "count": v[1],
                         "function": v[2], "joint_draw": v[3]}
                        for n, v in top],
        "lines": lines_seen,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--out", help="write the full summary (per-function "
                    "and top-kernel tables) to this JSON file")
    args = ap.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("sweep_profile: needs a GPU")
    sys.path.insert(0, REPO)
    from bayesfmmm_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import chip_smoke as cs

    import jax.numpy as jnp

    from bayesfmmm_tpu.config import Priors
    from bayesfmmm_tpu.utils.simulate import simulate_functional

    cfg = cs.HEADLINE
    data, truth = simulate_functional(
        seed=cfg["seed"], N=cfg["N"], K=cfg["K"], P=cfg["P"], M=cfg["M"],
        n_time=cfg["n_time"])
    run = cs.make_sweep_scan(data, Priors(), jnp.full((cfg["K"],), 10.0),
                             args.sweeps, collapsed_z=True, gauge=True)
    keys = jax.random.split(jax.random.PRNGKey(0), args.chains)
    states = cs._stack(jax.tree.map(jnp.asarray, truth), args.chains)
    compiled = run.lower(keys, states).compile()
    states = compiled(keys, states)
    jax.block_until_ready(states)
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(keys, states))
    untraced_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(compiled(keys, states))
        (xspace,) = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                              recursive=True)
        summary = reduce_trace(xspace, compiled.as_text())
    summary.update(device_kind=jax.devices()[0].device_kind,
                   xla_flags=os.environ.get("XLA_FLAGS", ""),
                   chains=args.chains, sweeps=args.sweeps,
                   untraced_window_s=untraced_s,
                   untraced_chain_sweeps_per_s=args.chains * args.sweeps
                   / untraced_s)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    brief = {k: summary[k] for k in (
        "device_kind", "xla_flags", "chains", "sweeps",
        "untraced_chain_sweeps_per_s", "memcpy_events",
        "window_ns", "busy_ns", "idle_share", "kernel_events",
        "events_without_hlo_metadata", "joint_draw_ns",
        "joint_draw_share_of_kernel_time")}
    brief["top_functions"] = dict(list(summary["by_function_ns"].items())[:12])
    print(json.dumps(brief))


if __name__ == "__main__":
    main()
