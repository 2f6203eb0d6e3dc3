"""Benchmark: maps/sec for the K=5 Chebyshev graph convolution at
nside=1024 (BASELINE.json), plus per-stage extras.

Orchestration
-------------
* The parent process (``python bench.py``) never imports jax, so only one
  process holds the accelerator.  It spawns one child
  (``python bench.py --stage a,b,c``) that runs the stages in order,
  merges the child's results and prints one result JSON line after every
  finished stage and once more at the end; the last line is the result.
* The child prints ``BENCH-STAGE-RESULT {json}`` marker lines after every
  sub-measurement, so a child that dies mid-stage keeps everything it
  measured before.  A stage that raises records ``<stage>_error``; the
  next stage still runs.
* Every stage has a soft wall-clock deadline inside the global budget
  (``BENCH_BUDGET_S``); a child past it is killed and a fresh child
  resumes with the remaining stages.
* Failure injection for testing: ``BENCH_INJECT_FAIL=stage1,stage2`` makes
  those stages raise; ``BENCH_INJECT_HANG=stage`` makes them hang (to
  exercise the timeout kill).  ``tests/test_bench_harness.py`` proves the
  final JSON prints with rc 0 under both.
* Every stage records the device it ran on (``platform``,
  ``device_kind``, ``device_count``); times end in ``block_until_ready``.

Measures the model-native **cface** path (the layout the model assembler
threads between layers): channels-first padded face images through the
per-step stencil conv (``deepsphere_tpu/ops/stencil.py``).  The ELLPACK
gather path is timed alongside in ``extra``.

``vs_baseline``: the reference repo publishes no benchmark numbers
(BASELINE.md), so we normalize against the only published throughput trace
— the quick_start classifier at ~0.6 s/step for batch 16 (26.7 maps/s on
unstated hardware, nside=64).  Our metric processes nside=1024 maps (256x
more pixels per map), so this normalization is very conservative.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

NSIDE = int(os.environ.get("BENCH_NSIDE", 1024))
K = 5
FIN = 4
FOUT = 4
BATCH = int(os.environ.get("BENCH_BATCH", 4))
REFERENCE_MAPS_PER_SEC = 16 / 0.6  # quick_start.ipynb cell 16 output

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", 1350))
# minimum useful child runtime: below this, don't even launch the stage
MIN_STAGE_S = float(os.environ.get("BENCH_MIN_STAGE_S", 90))
_T0 = time.time()

MARKER = "BENCH-STAGE-RESULT "
STAGE_START = "BENCH-STAGE-START "
STAGE_END = "BENCH-STAGE-END "

# (name, default-on, soft wall-clock cap in seconds), headline first.
# init: the first jit of the process and the headline graph build, timed
# apart so the measured stages cover steady-state work only.
STAGES = [
    ("init", "1", 420.0),
    ("core", "1", 650.0),
    ("model", "1", 560.0),
    ("k20", "1", 330.0),
    ("smooth", "1", 260.0),
    ("gather", "1", 90.0),
]


# --------------------------------------------------------------------------
# child-side helpers
# --------------------------------------------------------------------------

def _bank(extra):
    """Emit the stage's current results.  Flushed immediately so a later
    crash in the same child cannot lose them."""
    print(MARKER + json.dumps(extra), flush=True)


def _time(fn, tables, x, kernel, n_iters=20):
    """Mean seconds per call of ``fn(tables, x, kernel)`` after warm-up,
    each call chained on the previous output (Fin == Fout)."""
    z = fn(tables, x, kernel)  # compile + warmup
    for _ in range(3):
        z = fn(tables, z, kernel)
    z.block_until_ready()
    t0 = time.time()
    for _ in range(n_iters):
        z = fn(tables, z, kernel)
    z.block_until_ready()
    return (time.time() - t0) / n_iters


def _jax(extra):
    """Import jax with the persistent compile cache on, and record the
    device this stage runs on."""
    from deepsphere_tpu.utils import enable_compile_cache

    import jax

    enable_compile_cache()
    devices = jax.devices()
    extra["platform"] = devices[0].platform
    extra["device_kind"] = devices[0].device_kind
    extra["device_count"] = len(devices)
    return jax


def _headline_setup(jax, jnp, cache):
    """Graph + deep stencil + cface input for the nside=1024 stages."""
    from deepsphere_tpu.graph import build_sphere_graph
    from deepsphere_tpu.ops.stencil import cface_embed, stencil_tables

    t0 = time.time()
    graph = build_sphere_graph(NSIDE, k=8, method="grid", cache_dir=cache)
    st = graph.face_stencil(0.75, n_steps=K - 1)
    build_s = time.time() - t0

    kernel = jnp.asarray(
        np.random.RandomState(0).normal(scale=0.1, size=(FIN * K, FOUT)),
        dtype=jnp.float32,
    )
    x = jnp.asarray(
        np.random.RandomState(1).normal(size=(BATCH, graph.n_pixels, FIN)),
        dtype=jnp.float32,
    )
    # graph tables enter as jit ARGUMENTS (hundreds of MB — must not be
    # embedded into the HLO as constants)
    st_tables = jax.device_put(stencil_tables(st))
    x5 = cface_embed(x, NSIDE, K - 1)
    return graph, st, st_tables, kernel, x, x5, build_s


def stage_init(extra):
    """Time the process's first jit and the headline graph build (host
    precompute, disk-cached), so later stages measure warm work only."""
    jax = _jax(extra)
    import jax.numpy as jnp

    t0 = time.time()
    jax.jit(lambda a, b: a + b)(jnp.float32(1), jnp.float32(2)).block_until_ready()
    extra["init_first_jit_s"] = round(time.time() - t0, 1)
    _bank(extra)
    from deepsphere_tpu.graph import build_sphere_graph

    t0 = time.time()
    build_sphere_graph(NSIDE, k=8, method="grid", cache_dir=_cache_dir())
    extra["init_graph_s"] = round(time.time() - t0, 1)
    _bank(extra)


def stage_core(extra):
    """Headline cface conv + train step (+ opt-in face-flat wrapper)."""
    jax = _jax(extra)
    import jax.numpy as jnp

    from deepsphere_tpu.ops.stencil import (stencil_graph_conv,
                                            stencil_graph_conv_cface)

    cache = _cache_dir()
    graph, st, st_tables, kernel, x, x5, build_s = _headline_setup(
        jax, jnp, cache
    )
    extra["graph_build_s"] = round(build_s, 1)
    _bank(extra)

    @jax.jit
    def conv_cface(tables, x5, kernel):
        return stencil_graph_conv_cface(st, x5, kernel, K, "cheby",
                                        tables=tables)

    dt = _time(conv_cface, st_tables, x5, kernel)
    extra["step_ms"] = round(dt * 1e3, 2)
    _bank(extra)

    # training step at the headline config: fwd + dx + dW.  BOTH
    # cotangents must feed the next iteration — returning dx alone lets
    # XLA dead-code-eliminate the whole dW pass
    @jax.jit
    def train_like(tables, x5, kernel):
        def loss(x5, kernel):
            y = stencil_graph_conv_cface(st, x5, kernel, K, "cheby",
                                         tables=tables)
            return jnp.sum(y * y)

        _, (dx, dk) = jax.value_and_grad(loss, argnums=(0, 1))(x5, kernel)
        return dx, kernel - 1e-12 * dk

    z, kz = train_like(st_tables, x5, kernel)
    for _ in range(3):
        z, kz = train_like(st_tables, z, kz)
    kz.block_until_ready()
    t0 = time.time()
    for _ in range(10):
        z, kz = train_like(st_tables, z, kz)
    kz.block_until_ready()
    dt_t = (time.time() - t0) / 10
    extra["train_step_ms"] = round(dt_t * 1e3, 2)
    extra["train_over_fwd"] = round(dt_t / dt, 2)
    _bank(extra)

    # face-flat wrapper comparison (opt-in): what the NEST<->cface
    # conversion costs when paid per call
    if os.environ.get("BENCH_FACE_FLAT") == "1":
        @jax.jit
        def conv_stencil(tables, x, kernel):
            return stencil_graph_conv(
                st, x, kernel, K, "cheby", tables=tables, layout="face"
            )

        dt_f = _time(conv_stencil, st_tables, x, kernel, n_iters=5)
        extra["face_flat_step_ms"] = round(dt_f * 1e3, 2)
        _bank(extra)


def stage_gather(extra):
    """ELLPACK gather-path conv (the reference's own formulation) for the
    stencil_speedup comparison: banks after compile, then times one
    chained step."""
    jax = _jax(extra)
    import jax.numpy as jnp

    from deepsphere_tpu.graph import build_sphere_graph
    from deepsphere_tpu.ops.spmv import chebyshev_basis, graph_conv

    cache = _cache_dir()
    graph = build_sphere_graph(NSIDE, k=8, method="grid", cache_dir=cache)
    kernel = jnp.asarray(
        np.random.RandomState(0).normal(scale=0.1, size=(FIN * K, FOUT)),
        dtype=jnp.float32,
    )
    x = jnp.asarray(
        np.random.RandomState(1).normal(size=(BATCH, graph.n_pixels, FIN)),
        dtype=jnp.float32,
    )
    idx_np, val_np = graph.ellpack(0.75)
    ell = jax.device_put({"idx": idx_np, "val": val_np})

    @jax.jit
    def conv_gather(ell, x, kernel):
        return graph_conv(
            lambda x2d, nt: chebyshev_basis(ell["idx"], ell["val"], x2d, nt),
            x, kernel, K,
        )

    t0 = time.time()
    z = conv_gather(ell, x, kernel).block_until_ready()  # compile + run
    extra["gather_compile_s"] = round(time.time() - t0, 1)
    _bank(extra)
    t0 = time.time()
    z = conv_gather(ell, z, kernel).block_until_ready()
    extra["gather_path_step_ms"] = round((time.time() - t0) * 1e3, 2)
    _bank(extra)


def stage_model(extra):
    """quick_start-shaped model benchmark (reference architecture verbatim:
    4x Chebyshev K=10 + pools + mean-softmax head, quick_start.ipynb cell 7)
    at nside=64 batch 16 — catches regressions in layout converters, BN,
    pooling and the Trainer that the single-conv number cannot see.
    Reference baseline: ~0.6 s/step on unstated hardware (cell 16)."""
    jax = _jax(extra)
    import jax.numpy as jnp
    import optax

    import deepsphere_tpu as ds
    from chip_smoke import quickstart_layers

    cache = _cache_dir()
    nside = int(os.environ.get("BENCH_MODEL_NSIDE", 64))
    batch = 16
    npix = ds.sphere.healpix.nside2npix(nside)
    model = ds.HealpyGCNN(nside=nside, indices=np.arange(npix),
                          layers=quickstart_layers(), graph_cache_dir=cache)
    x = jnp.asarray(
        np.random.RandomState(2).normal(size=(batch, npix, 1)), jnp.float32
    )
    y = jnp.asarray(np.arange(batch) % 2, jnp.int32)
    variables = model.init(0, x)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    tables = {k: v for k, v in variables.items()
              if k not in ("params", "batch_stats")}

    # forward: chain x through a zero-coupled output term
    @jax.jit
    def fwd(tables, params, stats, x):
        out = model.module.apply(
            {**tables, "params": params, "batch_stats": stats}, x,
            training=False,
        )
        return x + 0.0 * jnp.sum(out), out

    xc, out = fwd(tables, params, stats, x)
    out.block_until_ready()
    n_it = 10
    t0 = time.time()
    for _ in range(n_it):
        xc, out = fwd(tables, params, stats, xc)
    out.block_until_ready()
    extra["qs_model_nside"] = nside
    extra["qs_fwd_ms"] = round((time.time() - t0) / n_it * 1e3, 2)
    _bank(extra)

    # train step: params/opt-state chain naturally
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(tables, params, stats, opt, x, y):
        def loss_fn(p):
            out, upd = model.module.apply(
                {**tables, "params": p, "batch_stats": stats}, x,
                training=True, mutable=["batch_stats"],
            )
            # quick_start head emits probabilities; clip like Keras CE
            logp = jnp.log(jnp.clip(out, 1e-7, 1.0))
            loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))
            return loss, upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, new_opt, loss

    params, stats, opt, loss = step(tables, params, stats, opt, x, y)
    loss.block_until_ready()
    t0 = time.time()
    for _ in range(n_it):
        params, stats, opt, loss = step(tables, params, stats, opt, x, y)
    loss.block_until_ready()
    qs_train = (time.time() - t0) / n_it
    extra["qs_train_step_ms"] = round(qs_train * 1e3, 2)
    extra["qs_train_maps_per_s"] = round(batch / qs_train, 1)
    _bank(extra)


def stage_k20(extra):
    """k=20 ring-template conv (radius-2 stencil) at nside=256: the
    reference treats k in {20,40,60} as first-class
    (healpy_networks.py:39-42)."""
    jax = _jax(extra)
    import jax.numpy as jnp

    from deepsphere_tpu.graph import build_sphere_graph
    from deepsphere_tpu.ops.reference import numpy_cheby_conv
    from deepsphere_tpu.ops.stencil import stencil_graph_conv, stencil_tables

    cache = _cache_dir()
    n20 = int(os.environ.get("BENCH_K20_NSIDE", 256))
    g20 = build_sphere_graph(n20, k=20, method="grid", cache_dir=cache)
    st20 = g20.deep_stencil(0.75, K)
    t20 = jax.device_put(stencil_tables(st20))
    kernel = jnp.asarray(
        np.random.RandomState(0).normal(scale=0.1, size=(FIN * K, FOUT)),
        dtype=jnp.float32,
    )
    x20 = jnp.asarray(
        np.random.RandomState(3).normal(size=(BATCH, g20.n_pixels, FIN)),
        jnp.float32,
    )

    # correctness first (vs the host float64 ELLPACK reference), so a
    # wrong-but-fast conv can't bank a number
    from deepsphere_tpu.sphere.faces import face2nest_index

    idx_np, val_np = g20.ellpack(0.75)
    y_ref_nest = numpy_cheby_conv(idx_np, val_np, np.asarray(x20),
                                  np.asarray(kernel), K)
    f2n = face2nest_index(n20)  # face position of each NEST pixel
    x20_face = np.empty_like(np.asarray(x20))
    x20_face[:, f2n, :] = np.asarray(x20)
    y_ref = np.empty_like(y_ref_nest)
    y_ref[:, f2n, :] = y_ref_nest
    x20 = jnp.asarray(x20_face)

    @jax.jit
    def conv20(tables, x, kernel):
        return stencil_graph_conv(
            st20, x, kernel, K, "cheby", tables=tables, layout="face"
        )

    y20 = np.asarray(conv20(t20, x20, kernel))
    err = float(np.max(np.abs(y20 - y_ref)))
    extra["k20_nside"] = n20
    extra["k20_max_abs_err"] = err
    extra["k20_ok"] = bool(err < 1e-4)
    _bank(extra)
    if not extra["k20_ok"]:
        extra["k20_error"] = f"max_abs_err {err:.3g} >= 1e-4; timing not banked"
        _bank(extra)
        return

    dt20 = _time(conv20, t20, x20, kernel, n_iters=10)
    extra["k20_step_ms"] = round(dt20 * 1e3, 2)
    extra["k20_maps_per_s"] = round(BATCH / dt20, 1)
    _bank(extra)


def stage_smooth(extra):
    """Gaussian smoothing at the headline resolution (sigma = 10 arcmin):
    the stencil-decomposition path (m repetitions of a radius-<=4 template;
    healpy_layers.py:510-853 semantics)."""
    jax = _jax(extra)
    import jax.numpy as jnp

    from deepsphere_tpu.nn.smoothing import HealpySmoothing, SmoothingOperator

    cache = _cache_dir()
    op = SmoothingOperator(
        nside=NSIDE, indices=np.arange(12 * NSIDE * NSIDE),
        sigma=10.0, method="stencil", data_path=cache,
    )
    lay = HealpySmoothing(operator=op)
    xs = jnp.asarray(
        np.random.RandomState(5).normal(size=(1, 12 * NSIDE * NSIDE, 1)),
        jnp.float32,
    )
    vs = lay.init(jax.random.PRNGKey(0), xs)
    tbl = {k: jax.device_put(v) for k, v in vs.items()}

    @jax.jit
    def smooth(tbl, xs):
        return lay.apply(tbl, xs)

    ys = smooth(tbl, xs).block_until_ready()
    t0 = time.time()
    for _ in range(5):
        ys = smooth(tbl, ys)
    ys.block_until_ready()
    extra["smooth_sigma10_ms"] = round((time.time() - t0) / 5 * 1e3, 2)
    extra["smooth_reps"] = int(op.stencil_reps)
    _bank(extra)


STAGE_FNS = {
    "init": stage_init,
    "core": stage_core,
    "model": stage_model,
    "gather": stage_gather,
    "k20": stage_k20,
    "smooth": stage_smooth,
}


def _cache_dir():
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    return cache


def child_main(stages):
    """Run a comma-list of stages SEQUENTIALLY in one process; print
    incremental marker lines.  A stage's exception is recorded as
    ``<stage>_error`` (traceback on stderr) and the next stage still runs —
    only a process-killing fault (device fault, OOM kill) ends the run
    early, and the parent then respawns with the remaining stages."""
    import traceback

    extra = {}
    inject_fail = os.environ.get("BENCH_INJECT_FAIL", "").split(",")
    inject_hang = os.environ.get("BENCH_INJECT_HANG", "").split(",")
    for stage in stages.split(","):
        print(STAGE_START + stage, flush=True)
        try:
            if stage in inject_fail:
                raise RuntimeError(f"injected failure in stage {stage}")
            if stage in inject_hang:
                time.sleep(10_000)
            STAGE_FNS[stage](extra)
        except Exception as e:  # noqa: BLE001 — reported, never fatal
            traceback.print_exc()
            extra[stage + "_error"] = f"{type(e).__name__}: {e}"[:300]
            _bank(extra)
        print(STAGE_END + stage, flush=True)
    return 0


# --------------------------------------------------------------------------
# parent side
# --------------------------------------------------------------------------

# nominal wall-clock of a stage whose executables are in the persistent
# compile cache (compile load + measurement loop)
WARM_STAGE_S = 120.0


def _stage_deadline(cap, n_pending=0):
    """Effective per-stage deadline.

    The deadline is SOFT: a stage may run past its cap as long as the
    remaining global budget still reserves a nominal warm-cache slot
    (``WARM_STAGE_S``) for each pending stage — killing a stage mid-compile
    would only make the next child compile again."""
    remaining = BUDGET_S - (time.time() - _T0)
    soft = max(cap, remaining - n_pending * WARM_STAGE_S - 30)
    return min(soft, max(remaining - 30, MIN_STAGE_S))


def _run_stages_child(stage_caps, extra):
    """Spawn ONE ``python bench.py --stage a,b,c`` child over all pending
    stages, stream its stdout, and enforce per-stage deadlines.

    Marker lines are merged into ``extra`` AS THEY ARRIVE.  When the
    current stage exceeds its deadline the child is killed.

    Returns (completed stage names, stage being run when the child died or
    None).
    """
    import queue
    import threading

    names = [n for n, _ in stage_caps]
    caps = dict(stage_caps)
    cmd = [sys.executable, os.path.abspath(__file__), "--stage",
           ",".join(names)]
    print(f"[bench] child: launching stages {names}",
          file=sys.stderr, flush=True)
    try:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=None,
            text=True, errors="replace", bufsize=1,
        )
    except Exception as e:  # spawn failure
        for n in names:
            extra.setdefault(n + "_error", f"spawn failed: {e}"[:200])
        return [], None

    q = queue.Queue()

    def reader():
        for line in proc.stdout:
            q.put(line.rstrip("\n"))
        q.put(None)

    threading.Thread(target=reader, daemon=True).start()

    completed = []
    current = None
    t_stage = time.time()
    deadline = _stage_deadline(caps[names[0]], len(names) - 1)
    eof = False
    while not eof:
        try:
            line = q.get(timeout=1.0)
        except queue.Empty:
            line = ""
        if line is None:
            eof = True
        elif line.startswith(MARKER):
            try:
                extra.update(json.loads(line[len(MARKER):]))
            except ValueError:
                pass
        elif line.startswith(STAGE_START):
            current = line[len(STAGE_START):].strip()
            t_stage = time.time()
            n_pending = (len(names) - 1 - names.index(current)
                         if current in names else 0)
            deadline = _stage_deadline(caps.get(current, 300.0), n_pending)
            print(f"[bench] stage {current}: started "
                  f"(deadline {deadline:.0f}s)", file=sys.stderr, flush=True)
        elif line.startswith(STAGE_END):
            done = line[len(STAGE_END):].strip()
            completed.append(done)
            print(f"[bench] stage {done}: done in "
                  f"{time.time() - t_stage:.0f}s", file=sys.stderr,
                  flush=True)
            # bank the cumulative result after every finished stage: the
            # driver parses the LAST JSON line, so a SIGKILL of the
            # parent mid-run still leaves everything so far on record
            print(json.dumps(_result(dict(extra))), flush=True)
            current = None
        if current is not None and time.time() - t_stage > deadline:
            extra.setdefault(
                current + "_error",
                f"stage timeout after {deadline:.0f}s",
            )
            proc.kill()
            # drain the reader to EOF so banked markers are not lost
            while True:
                tail_line = q.get()
                if tail_line is None:
                    break
                if tail_line.startswith(MARKER):
                    try:
                        extra.update(json.loads(tail_line[len(MARKER):]))
                    except ValueError:
                        pass
            return completed, current
        if current is None and not eof and \
                BUDGET_S - (time.time() - _T0) < 5:
            proc.kill()  # out of global budget between stages
            return completed, None
    rc = proc.wait()
    if rc != 0 and current is not None:
        extra.setdefault(
            current + "_error", f"child died rc={rc} during {current}"
        )
    return completed, current if rc != 0 else None


def _result(extra):
    """The driver-facing result JSON for the current state of ``extra``."""
    step_ms = extra.get("step_ms")
    maps_per_sec = BATCH / (step_ms / 1e3) if step_ms else 0.0
    if extra.get("gather_path_step_ms") and step_ms:
        extra["stencil_speedup"] = round(
            extra["gather_path_step_ms"] / step_ms, 2
        )
    return {
        "metric": f"maps/sec/chip nside={NSIDE} K={K} Chebyshev conv fwd "
                  f"(Fin={FIN} Fout={FOUT} batch={BATCH})",
        "value": round(maps_per_sec, 3),
        "unit": "maps/s",
        "vs_baseline": round(maps_per_sec / REFERENCE_MAPS_PER_SEC, 3),
        "extra": extra,
    }


def parent_main():
    extra = {}
    try:
        pending = [
            (name, cap) for name, default_on, cap in STAGES
            if os.environ.get("BENCH_" + name.upper(), default_on) == "1"
        ]
        while pending:
            remaining = BUDGET_S - (time.time() - _T0)
            if remaining < MIN_STAGE_S:
                for name, _ in pending:
                    extra.setdefault(
                        name + "_skipped",
                        "wall-clock budget (BENCH_BUDGET_S)",
                    )
                break
            completed, died_in = _run_stages_child(pending, extra)
            print(json.dumps(_result(dict(extra))), flush=True)
            done_or_dead = set(completed) | ({died_in} if died_in else set())
            pending = [(n, c) for n, c in pending if n not in done_or_dead]
    except BaseException as e:  # noqa: BLE001 — the finally must still print
        extra["orchestrator_error"] = f"{type(e).__name__}: {e}"[:200]
    finally:
        if not extra.get("step_ms"):
            extra.setdefault("headline_error", "no step_ms measured")
        print(json.dumps(_result(extra)), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        sys.exit(child_main(sys.argv[2]))
    parent_main()


if __name__ == "__main__":
    main()
