"""Smoke test of the whole GPU path, in one process.

    python chip_smoke.py           # phases 1-5 on one GPU
    python chip_smoke.py --four    # phase 1 + the 4-GPU sharded step (6)

Phases run in order and any failure ends the run with a non-zero exit
code; only a run in which every phase passed prints the last line
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

1. Device: a GPU backend (never the CPU), its kind and count, and the
   card's name and power limit from ``nvidia-smi``.
2. quick_start classifier (four K=10 Chebyshev convs with BN and pools,
   mean-softmax head) at nside=64, batch 16: ``compile``/``fit`` with a
   finite, falling loss; ``save_weights`` -> ``load_weights`` into a fresh
   model and ``save_exported`` -> ``serve.load_exported`` both reproduce
   ``predict``.
3. Headline conv (nside=1024, B=4, Fin=Fout=4, K=5 Chebyshev): the cface
   stencil path and the ELLPACK path against the host float64 reference,
   gradients of the stencil path against autodiff of the ELLPACK path,
   and a smoke timing of each beside the single-pass byte floor.
4. Full-sky model (the flagship stack of ``__graft_entry__``) at
   nside=1024 with ``remat=True``: memory analysis of the compiled train
   step, then three steps with a finite loss and the peak memory.
5. k=20 (radius-2) conv and sigma=10' smoothing at nside=256, each against
   its ELLPACK form and the host float64 reference.
6. ``--four``: one train step of the ``dryrun_multichip`` stack at
   nside=256 on a data=2 x pixel=2 mesh of four GPUs against the same
   step on one device.

Timings printed here are smoke timings of warm calls, each ended by
``block_until_ready``; they are not benchmarks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FWD_TOL = 1e-5  # max |y - y_ref| / max |y_ref|
GRAD_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def log(msg):
    print(msg, flush=True)


def card_info():
    """``name, power.limit`` of each card, from nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def warm_time(fn, *args, iters=10):
    """Mean seconds per warm call of ``fn(*args)``."""
    fn(*args).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters


def _cache_dir():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache")
    os.makedirs(path, exist_ok=True)
    return path


def tree_rel_err(got, want):
    """``max |a - b| / max |b|`` over all leaves of two gradient trees: the
    error of every parameter's gradient relative to the largest gradient
    of the step, as :func:`rel_err` is for one array."""
    import jax

    pairs = list(zip(jax.tree_util.tree_leaves(got),
                     jax.tree_util.tree_leaves(want)))
    diff = max(float(np.max(np.abs(np.asarray(a, np.float64) - b)))
               for a, b in pairs)
    return diff / max(float(np.max(np.abs(b))) for _, b in pairs)


# --------------------------------------------------------------------------
# phase 2: quick_start classifier through the user entry points
# --------------------------------------------------------------------------

def quickstart_layers(K=10):
    import jax
    import jax.numpy as jnp

    from deepsphere_tpu.nn import core
    from deepsphere_tpu.nn import healpy_layers as hp_nn

    class MeanSoftmax(core.Module):
        @core.compact
        def __call__(self, x, training=False):
            return jax.nn.softmax(jnp.mean(x, axis=1), axis=-1)

    conv = dict(K=K, Fout=5, use_bias=True, use_bn=True, activation="relu")
    return [
        hp_nn.HealpyChebyshev(**conv), hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(**conv), hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(**conv), hp_nn.HealpyPool(p=1),
        hp_nn.HealpyChebyshev(K=K, Fout=2),
        MeanSoftmax(),
    ]


def two_class_maps(nside, n, seed):
    """Seeded synthetic maps: class 1 carries a smooth polar bump."""
    from deepsphere_tpu.sphere import healpix as hp

    npix = hp.nside2npix(nside)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, size=n)
    x = rng.normal(size=(n, npix, 1)).astype(np.float32)
    v = hp.pix2vec(nside, np.arange(npix), nest=True)
    bump = 0.7 * np.exp(-((v - np.array([0.0, 0.0, 1.0])) ** 2).sum(1))
    x[labels == 1, :, 0] += bump.astype(np.float32)
    return x, labels


def phase_quickstart(nside=64, batch=16, n_maps=64, epochs=4, K=10):
    import deepsphere_tpu as ds
    from deepsphere_tpu import serve

    npix = 12 * nside * nside
    x, y = two_class_maps(nside, n_maps, seed=3)

    def make():
        return ds.HealpyGCNN(nside=nside, indices=np.arange(npix),
                             layers=quickstart_layers(K),
                             graph_cache_dir=_cache_dir())

    model = make()
    model.build((batch, npix, 1))
    model.compile(optimizer=1e-3, loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    t0 = time.perf_counter()
    hist = model.fit(x, y, batch_size=batch, epochs=epochs, verbose=0)
    fit_s = time.perf_counter() - t0
    losses = hist["loss"]
    check(np.all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    y_pred = model.predict(x[:batch], batch_size=batch)

    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "weights.npz")
        model.save_weights(wpath)
        fresh = make()
        fresh.build((batch, npix, 1), rng=1)
        fresh.load_weights(wpath)
        err_w = float(np.max(np.abs(fresh.predict(x[:batch], batch_size=batch)
                                    - y_pred)))
        check(err_w <= 1e-6, f"load_weights predict differs by {err_w}")

        epath = os.path.join(tmp, "model.dsx")
        model.save_exported(epath, batch_size=None)
        em = serve.load_exported(epath)
        err_e = float(np.max(np.abs(np.asarray(em(x[:batch])) - y_pred)))
        check(err_e <= 1e-6, f"exported replay differs by {err_e}")
    return {"losses": [float(v) for v in losses], "fit_s": fit_s,
            "weights_err": err_w, "export_err": err_e,
            "steps": epochs * (-(-n_maps // batch))}


# --------------------------------------------------------------------------
# phase 3: headline conv, stencil and ELLPACK against the f64 reference
# --------------------------------------------------------------------------

def phase_headline(nside=1024, batch=4, fin=4, fout=4, K=5, iters=10):
    import jax
    import jax.numpy as jnp

    from deepsphere_tpu.graph import build_sphere_graph
    from deepsphere_tpu.ops.reference import numpy_cheby_conv
    from deepsphere_tpu.ops.spmv import chebyshev_basis, graph_conv
    from deepsphere_tpu.ops.stencil import (cface_embed, cface_extract,
                                            stencil_graph_conv_cface,
                                            stencil_tables)

    g = build_sphere_graph(nside, k=8, method="grid", cache_dir=_cache_dir())
    st = g.deep_stencil(0.75, K)
    h = st.n_steps
    tables = jax.device_put(stencil_tables(st))
    idx, val = g.ellpack(0.75)
    ell = jax.device_put({"idx": idx, "val": val})
    # NEST id at each face position / face position of each NEST pixel
    perm = jax.device_put({"n2f": st.n2f, "f2n": st.f2n})

    rs = np.random.RandomState(0)
    x_nest = rs.normal(size=(batch, g.n_pixels, fin)).astype(np.float32)
    kern = (0.1 * rs.normal(size=(fin * K, fout))).astype(np.float32)
    cot = jnp.asarray(rs.normal(size=(batch, g.n_pixels, fout)), jnp.float32)
    xn = jnp.asarray(x_nest)
    kj = jnp.asarray(kern)

    @jax.jit
    def stencil_fwd(tables, x5, w):
        return stencil_graph_conv_cface(st, x5, w, K, "cheby", tables=tables)

    @jax.jit
    def ellpack_fwd(ell, x, w):
        return graph_conv(
            lambda x2d, nt: chebyshev_basis(ell["idx"], ell["val"], x2d, nt),
            x, w, K)

    @jax.jit
    def to_cface(perm, x_nest):
        return cface_embed(jnp.take(x_nest, perm["n2f"], axis=1), nside, h)

    @jax.jit
    def to_nest(perm, y5):
        return jnp.take(cface_extract(y5, h), perm["f2n"], axis=1)

    @jax.jit
    def stencil_vjp(tables, perm, x, w, cot):
        """Gradients of the cface path seen from NEST in/out."""
        def f(x, w):
            return to_nest(perm, stencil_fwd(tables, to_cface(perm, x), w))

        return jax.vjp(f, x, w)[1](cot)

    @jax.jit
    def ellpack_vjp(ell, x, w, cot):
        _, vjp = jax.vjp(lambda x, w: ellpack_fwd(ell, x, w), x, w)
        return vjp(cot)

    x5 = to_cface(perm, xn)
    y_st = np.asarray(to_nest(perm, stencil_fwd(tables, x5, kj)))
    y_el = np.asarray(ellpack_fwd(ell, xn, kj))
    y_ref = numpy_cheby_conv(idx, val, x_nest, kern, K)
    err_st, err_el = rel_err(y_st, y_ref), rel_err(y_el, y_ref)
    check(err_st <= FWD_TOL, f"stencil forward rel err {err_st:.3g}")
    check(err_el <= FWD_TOL, f"ELLPACK forward rel err {err_el:.3g}")

    dx_st, dw_st = stencil_vjp(tables, perm, xn, kj, cot)
    dx_el, dw_el = ellpack_vjp(ell, xn, kj, cot)
    err_dx, err_dw = rel_err(dx_st, dx_el), rel_err(dw_st, dw_el)
    check(err_dx <= GRAD_TOL, f"stencil dx rel err {err_dx:.3g}")
    check(err_dw <= GRAD_TOL, f"stencil dW rel err {err_dw:.3g}")

    t_st = warm_time(stencil_fwd, tables, x5, kj, iters=iters)
    t_el = warm_time(ellpack_fwd, ell, xn, kj, iters=iters)
    M = g.n_pixels
    floor_bytes = 4 * (M * batch * fin + 9 * M + M * batch * fout)
    return {"err_stencil": err_st, "err_ellpack": err_el,
            "err_dx": err_dx, "err_dw": err_dw,
            "stencil_ms": t_st * 1e3, "ellpack_ms": t_el * 1e3,
            "floor_bytes": floor_bytes,
            "floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3}


# --------------------------------------------------------------------------
# phase 4: full-sky model trained
# --------------------------------------------------------------------------

def phase_fullsky(nside=1024, batch=4, steps=3, remat=True):
    import jax
    import jax.numpy as jnp

    import deepsphere_tpu as ds
    from __graft_entry__ import flagship_layers

    npix = 12 * nside * nside
    model = ds.HealpyGCNN(nside=nside, indices=np.arange(npix),
                          layers=flagship_layers(), remat=remat,
                          graph_cache_dir=_cache_dir())
    model.build((batch, npix, 1))
    trainer = model.compile(optimizer=1e-3,
                            loss="sparse_categorical_crossentropy_from_logits")
    trainer.init_state()
    rs = np.random.RandomState(4)
    x = jnp.asarray(rs.normal(size=(batch, npix, 1)), jnp.float32)
    y = jnp.asarray(np.arange(batch) % 4, jnp.int32)
    s = trainer.state
    compiled = trainer._train_step.lower(
        s.params, s.batch_stats, trainer._static_collections, s.opt_state,
        x, y).compile()
    ma = compiled.memory_analysis()
    need = (ma.argument_size_in_bytes + ma.output_size_in_bytes
            + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    dev = jax.devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    check(limit is None or need <= limit,
          f"train step needs {need} B, device limit {limit} B")
    losses = [trainer.train_on_batch(x, y)["loss"] for _ in range(steps)]
    check(np.all(np.isfinite(losses)), f"non-finite loss {losses}")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    return {"losses": losses, "argument_bytes": ma.argument_size_in_bytes,
            "output_bytes": ma.output_size_in_bytes,
            "temp_bytes": ma.temp_size_in_bytes,
            "alias_bytes": ma.alias_size_in_bytes, "need_bytes": need,
            "limit_bytes": limit, "peak_bytes": peak, "batch": batch}


# --------------------------------------------------------------------------
# phase 5: the other stencil families
# --------------------------------------------------------------------------

def phase_k20(nside=256, batch=4, fin=4, fout=4, K=5):
    import jax
    import jax.numpy as jnp

    from deepsphere_tpu.graph import build_sphere_graph
    from deepsphere_tpu.ops.reference import numpy_cheby_conv
    from deepsphere_tpu.ops.spmv import chebyshev_basis, graph_conv
    from deepsphere_tpu.ops.stencil import stencil_graph_conv, stencil_tables

    g = build_sphere_graph(nside, k=20, method="grid", cache_dir=_cache_dir())
    st = g.deep_stencil(0.75, K)
    check(st is not None and st.radius == 2, "k=20 graph has no radius-2 stencil")
    tables = jax.device_put(stencil_tables(st))
    idx, val = g.ellpack(0.75)
    ell = jax.device_put({"idx": idx, "val": val})
    rs = np.random.RandomState(1)
    x = rs.normal(size=(batch, g.n_pixels, fin)).astype(np.float32)
    kern = (0.1 * rs.normal(size=(fin * K, fout))).astype(np.float32)
    cot = jnp.asarray(rs.normal(size=(batch, g.n_pixels, fout)), jnp.float32)

    # graph tables are jit arguments, never HLO constants
    def stencil(tables, x, w):
        return stencil_graph_conv(st, x, w, K, "cheby", tables=tables)

    def ellpack(ell, x, w):
        return graph_conv(
            lambda x2d, nt: chebyshev_basis(ell["idx"], ell["val"], x2d, nt),
            x, w, K)

    y_ref = numpy_cheby_conv(idx, val, x, kern, K)
    err_st = rel_err(jax.jit(stencil)(tables, x, kern), y_ref)
    err_el = rel_err(jax.jit(ellpack)(ell, x, kern), y_ref)
    check(err_st <= FWD_TOL, f"k=20 stencil rel err {err_st:.3g}")
    check(err_el <= FWD_TOL, f"k=20 ELLPACK rel err {err_el:.3g}")
    vjp = jax.jit(
        lambda f, t, x, w, c: jax.vjp(lambda x, w: f(t, x, w), x, w)[1](c),
        static_argnums=0)
    g_st = vjp(stencil, tables, x, kern, cot)
    g_el = vjp(ellpack, ell, x, kern, cot)
    err_dx, err_dw = rel_err(g_st[0], g_el[0]), rel_err(g_st[1], g_el[1])
    check(err_dx <= GRAD_TOL and err_dw <= GRAD_TOL,
          f"k=20 grads rel err dx {err_dx:.3g} dW {err_dw:.3g}")
    return {"err_stencil": err_st, "err_ellpack": err_el,
            "err_dx": err_dx, "err_dw": err_dw}


def phase_smoothing(nside=256, sigma_arcmin=10.0, batch=2, channels=2):
    import jax
    import jax.numpy as jnp

    from deepsphere_tpu.nn.smoothing import (HealpySmoothing,
                                             SmoothingOperator,
                                             _stencil_decomposition,
                                             _template_ellpack)
    from deepsphere_tpu.ops.reference import numpy_ellpack_spmv
    from deepsphere_tpu.ops.spmv import ellpack_spmv
    from deepsphere_tpu.sphere import healpix as hp

    npix = 12 * nside * nside
    op = SmoothingOperator(nside=nside, indices=np.arange(npix),
                           sigma=sigma_arcmin, method="stencil")
    check(op.stencil is not None, "smoothing did not take the stencil path")
    m, sig, r = _stencil_decomposition(op.sigma_rad, hp.nside2resol(nside),
                                       op.n_sigma_support)
    idx, val = _template_ellpack(nside, sig, r, op.n_sigma_support)
    ell = jax.device_put({"idx": idx, "val": val.astype(np.float32)})
    lay = HealpySmoothing(operator=op)
    rs = np.random.RandomState(2)
    x = rs.normal(size=(batch, npix, channels)).astype(np.float32)
    cot = jnp.asarray(rs.normal(size=x.shape), jnp.float32)
    v = lay.init(jax.random.key(0), jnp.asarray(x))

    # graph tables are jit arguments, never HLO constants
    def stencil(v, x):
        return lay.apply(v, x)

    def ellpack(ell, x):
        y = jnp.transpose(x, (1, 0, 2)).reshape(npix, -1)
        for _ in range(m):
            y = ellpack_spmv(ell["idx"], ell["val"], y)
        return jnp.transpose(y.reshape(npix, batch, channels), (1, 0, 2))

    y_ref = np.transpose(x, (1, 0, 2)).reshape(npix, -1).astype(np.float64)
    for _ in range(m):
        y_ref = numpy_ellpack_spmv(idx, val, y_ref)
    y_ref = np.transpose(y_ref.reshape(npix, batch, channels), (1, 0, 2))
    err_st = rel_err(jax.jit(stencil)(v, x), y_ref)
    err_el = rel_err(jax.jit(ellpack)(ell, x), y_ref)
    check(err_st <= FWD_TOL, f"smoothing stencil rel err {err_st:.3g}")
    check(err_el <= FWD_TOL, f"smoothing ELLPACK rel err {err_el:.3g}")
    vjp = jax.jit(
        lambda f, t, x, c: jax.vjp(lambda x: f(t, x), x)[1](c)[0],
        static_argnums=0)
    err_dx = rel_err(vjp(stencil, v, x, cot), vjp(ellpack, ell, x, cot))
    check(err_dx <= GRAD_TOL, f"smoothing grad rel err {err_dx:.3g}")
    return {"reps": m, "radius": r, "err_stencil": err_st,
            "err_ellpack": err_el, "err_dx": err_dx}


# --------------------------------------------------------------------------
# phase 6: four GPUs, DP x pixel sharded step against one device
# --------------------------------------------------------------------------

def phase_four(nside=256, batch=4, devices=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    import deepsphere_tpu as ds
    from __graft_entry__ import (assert_halo_sharded, multichip_layers,
                                 multichip_loss_fn)
    from deepsphere_tpu.parallel import P, ShardConfig, make_mesh

    devices = list(devices if devices is not None else jax.devices())
    check(len(devices) >= 4, f"need 4 devices, have {len(devices)}")
    mesh = make_mesh(shape=(2, 2), axis_names=("data", "pixel"),
                     devices=devices[:4])
    cfg = ShardConfig(mesh=mesh, data_axis="data", pixel_axis="pixel")
    npix = 12 * nside * nside
    kw = dict(nside=nside, indices=np.arange(npix),
              graph_cache_dir=_cache_dir())
    m_one = ds.HealpyGCNN(layers=multichip_layers(), **kw)
    m_sh = ds.HealpyGCNN(layers=multichip_layers(), shard_cfg=cfg, **kw)
    assert_halo_sharded(m_sh, cfg)

    rs = np.random.RandomState(6)
    x = jnp.asarray(rs.normal(size=(batch, npix, 1)), jnp.float32)
    y = jnp.asarray(np.arange(batch) % 4, jnp.int32)
    v_one = m_one.init(0, x)
    v_sh = m_sh.init(0, x)
    params = v_one["params"]

    def run(model, variables, place):
        step = jax.jit(jax.value_and_grad(multichip_loss_fn(model),
                                          has_aux=True))
        args = (params, variables.get("batch_stats", {}),
                variables.get("graph_tables", {}), x, y)
        (loss, stats), grads = step(*place(args))
        return float(loss), jax.device_get(grads)

    one = devices[0]
    loss_1, g_1 = run(m_one, v_one, lambda a: jax.device_put(a, one))
    rep = NamedSharding(mesh, P())

    def place_sharded(a):
        p, s, t, xb, yb = a
        return (jax.device_put(p, rep), jax.device_put(s, rep),
                jax.device_put(t, rep),
                jax.device_put(xb, NamedSharding(mesh, P("data", "pixel", None))),
                jax.device_put(yb, NamedSharding(mesh, P("data"))))

    loss_4, g_4 = run(m_sh, v_sh, place_sharded)
    check(np.isfinite(loss_4), f"non-finite sharded loss {loss_4}")
    err_loss = abs(loss_4 - loss_1) / abs(loss_1)
    err_grad = tree_rel_err(g_4, g_1)
    check(err_loss <= FWD_TOL, f"sharded loss rel err {err_loss:.3g}")
    check(err_grad <= GRAD_TOL, f"sharded grads rel err {err_grad:.3g}")
    return {"loss_one": loss_1, "loss_four": loss_4,
            "err_loss": err_loss, "err_grad": err_grad}


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded step and its comparison")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    d0 = devices[0]
    log(f"device: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devices)}")
    cards = card_info()
    for line in cards:
        log(f"nvidia-smi: {line}")
    card = f"[{cards[0]}]"

    from deepsphere_tpu import config
    from deepsphere_tpu.utils import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    config.set_matmul_precision("highest")

    if args.four:
        r = phase_four()
        log(f"phase 6 four GPUs {card}: loss one-device {r['loss_one']!r} "
            f"four-GPU {r['loss_four']!r} rel err {r['err_loss']:.3g}, "
            f"grads rel err {r['err_grad']:.3g}")
        count = 4
    else:
        t0 = time.perf_counter()
        r = phase_quickstart()
        log(f"phase 2 quick_start {card}: losses {r['losses']} over "
            f"{r['steps']} steps, fit {r['fit_s']:.1f} s (smoke timing, "
            f"compile included); load_weights err {r['weights_err']:.3g}, "
            f"export err {r['export_err']:.3g}")
        r = phase_headline()
        log(f"phase 3 headline conv {card}: rel err stencil "
            f"{r['err_stencil']:.3g} ELLPACK {r['err_ellpack']:.3g}, "
            f"grads dx {r['err_dx']:.3g} dW {r['err_dw']:.3g}")
        log(f"phase 3 smoke timing, not a benchmark {card}: cface stencil "
            f"{r['stencil_ms']:.3f} ms/call, ELLPACK {r['ellpack_ms']:.3f} "
            f"ms/call; single-pass byte floor {r['floor_bytes'] / 1e9:.2f} GB "
            f"/ {HBM_BYTES_PER_S / 1e12:.2f} TB/s = {r['floor_ms']:.3f} ms")
        r = phase_fullsky()
        log(f"phase 4 full-sky train {card}: batch {r['batch']} memory "
            f"analysis arguments {r['argument_bytes']} B outputs "
            f"{r['output_bytes']} B temp {r['temp_bytes']} B aliased "
            f"{r['alias_bytes']} B, need {r['need_bytes']} B of "
            f"{r['limit_bytes']} B; losses {r['losses']}; peak_bytes_in_use "
            f"since process start {r['peak_bytes']}")
        r = phase_k20()
        log(f"phase 5 k=20 conv {card}: rel err stencil "
            f"{r['err_stencil']:.3g} ELLPACK {r['err_ellpack']:.3g}, grads "
            f"dx {r['err_dx']:.3g} dW {r['err_dw']:.3g}")
        r = phase_smoothing()
        log(f"phase 5 smoothing sigma=10' {card}: {r['reps']} rep(s) of a "
            f"radius-{r['radius']} template, rel err stencil "
            f"{r['err_stencil']:.3g} ELLPACK {r['err_ellpack']:.3g}, grad "
            f"{r['err_dx']:.3g}")
        log(f"phases 2-5 took {time.perf_counter() - t0:.1f} s {card}")
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
