"""Smoke run of the NNDescent build and query path on NVIDIA GPUs.

    python chip_smoke.py                # one card: phases b, a, c
    python chip_smoke.py --four-cards   # four cards: phase d only

One card, SIFT-1M-class data (1M x 128 float32 euclidean, k=10) generated on
the device from a seed (``bench.make_device_data``):

  b. The XLA stages that replaced the old hand-written kernels, at real
     widths, against NumPy float64 references: the forest leaf init at 1M x
     128, and the exact window top-m sweep (win 1024, m 32) at d=128 and
     d=784. Each is timed cold (compile + run) and warm.
  a. ``NNDescent(data, n_neighbors=10)`` with the default ``locality="auto"``
     (forest, leaf init, 12 window sweeps, global join iterations, rerank),
     ``neighbor_graph``, ``prepare()`` and ``query(10k queries, k=10,
     epsilon=0.25)``. Graph recall@10 (1,024 sampled rows) and strict query
     recall@10 (1,024 sampled queries) against the on-device exact oracle
     (``bench.exact_knn``). The build runs twice: cold, then warm; the two
     graphs must be bit-identical.
  c. Determinism: two same-seed builds at 100k x 128 give bit-identical
     neighbor ids.

Four cards (``--four-cards``, and nothing else):

  d. ``NNDescent(devices=4)`` at 1M x 128, then with ``shard_data=True``,
     then ``update(xs_fresh=...)`` and a query; each against the exact
     oracle at the phase-a floors, and the sharded graphs against a
     single-card graph (overlap and k-th distance, as in
     tests/test_parallel.py). The neighbor state must be spread over all
     four cards.

Everything measured goes on lines before the last; the last line is one JSON
object ``{"ok": true, "device": {...}}``. Any failed phase raises, so the
script exits non-zero and prints no ``"ok"``. It refuses every platform but
``gpu``. Sizes can be cut with --n / --queries / --det-n to rehearse.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

K = 10
EPSILON = 0.25
STRICT_FLOOR = 0.95  # query recall@10, strict ids
GRAPH_FLOOR = 0.98  # neighbor_graph recall@10 (the repo's build floor)
# Distances are fp32 products at Precision.HIGHEST, which on an H100 turns
# TF32 off. Against float64 NumPy the gram form |x|^2 + |y|^2 - 2<x, y>
# leaves ~1e-5 relative error at these data scales; a TF32 product (10-bit
# mantissa) would miss 1e-4 by an order of magnitude.
RTOL = 1e-4
F32_EPS = float(np.finfo(np.float32).eps)


def require_gpu(devices):
    """Refuse to run anywhere but on a GPU: a CPU run measures nothing this
    script reports."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found platform {platform!r}"
        )


def card_lines():
    """Name and power limit of each card, from nvidia-smi (a child process
    that never imports JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  pass: {what}", flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def peak_bytes(device=None):
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class FirstCall:
    """Wraps a module-level jitted stage and keeps the arguments of its first
    call, so ``memory()`` can report ``compiled.memory_analysis()`` for
    exactly the program the library ran (the persistent cache makes the
    second compile a lookup)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.fn(*args, **kwargs)

    def memory(self):
        if self.args is None:
            return None
        args, kwargs = self.args
        ma = self.fn.lower(*args, **kwargs).compile().memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        return {f: getattr(ma, f, None) for f in fields}

    def restore(self):
        setattr(self.module, self.name, self.fn)


def recall(found, truth):
    """Mean |found[i, :k] ∩ truth[i]| / k."""
    found = np.asarray(found)[:, : truth.shape[1]]
    hits = (found[:, :, None] == truth[:, None, :]).any(-1) & (found >= 0)
    return float(hits.sum() / truth.size)


def graph_recall(graph_idx, X, rows, bench):
    truth = np.asarray(bench.exact_knn(X[rows], X, K))
    return recall(np.asarray(graph_idx)[rows], truth)


# ---------------------------------------------------------------------------
# phase b: the XLA stages against NumPy references, at real widths
# ---------------------------------------------------------------------------


def _np_sqdist(A, B):
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    return np.maximum(
        (A * A).sum(1)[:, None] + (B * B).sum(1)[None] - 2.0 * A @ B.T, 0.0
    )


def check_window_sweep(X, order, label, timings, n_windows=4, seed=0):
    from pynndescent_tpu.ops import nndescent as nnd_ops

    win, m = 1024, 32
    Xp = X[jnp.asarray(order)]
    run = lambda: nnd_ops.window_topm(Xp, win=win, m=m, metric="sqeuclidean")
    _, cold = timed(run)
    (ids, dd), warm = timed(run)
    timings[f"sweep_{label}"] = {"cold_s": cold, "warm_s": warm}
    print(f"  window sweep {label}: n={Xp.shape[0]} d={Xp.shape[1]} "
          f"cold {cold:.3f} s, warm {warm:.3f} s", flush=True)
    ids, dd = np.asarray(ids), np.asarray(dd)
    n = Xp.shape[0]
    full = n // win
    rs = np.random.RandomState(seed)
    for w in rs.choice(full, min(n_windows, full), replace=False):
        s, e = w * win, (w + 1) * win
        D = _np_sqdist(Xp[s:e], Xp[s:e])
        np.fill_diagonal(D, np.inf)
        want = np.sort(D, axis=1)[:, :m]
        check(np.all((ids[s:e] >= s) & (ids[s:e] < e)),
              f"sweep {label} window {w}: ids stay in the window")
        own = np.take_along_axis(D, ids[s:e] - s, axis=1)
        np.testing.assert_allclose(dd[s:e], want, rtol=RTOL, atol=0)
        np.testing.assert_allclose(dd[s:e], own, rtol=RTOL, atol=0)
        check(True, f"sweep {label} window {w}: top-{m} distances within rtol {RTOL}")


def check_leaf_init(X, label, timings, n_rows=256, seed=0):
    from pynndescent_tpu.ops import nndescent as nnd_ops
    from pynndescent_tpu.ops import rp_trees
    from pynndescent_tpu.ops.neighbors import make_neighbor_state

    n, d = X.shape
    leaf = rp_trees.default_leaf_size(K)
    cap = min(leaf, 64)
    T = rp_trees.default_n_trees(n)
    # the forest and block width exactly as NNDescent / nn_descent build them
    orders, starts, sizes = jax.block_until_ready(rp_trees.build_forest_orders(
        X.astype(jnp.bfloat16), jnp.arange(1, T + 1, dtype=jnp.uint32), leaf,
        rp_trees.forest_depth(n, leaf),
    ))
    block = int(max(256, min(8192, (1 << 32) // max(T * cap * d * 4, 1))))
    dist_rowwise = nnd_ops._resolve_rowwise_metric("sqeuclidean", None)
    state0 = make_neighbor_state(n, K)
    run = lambda: nnd_ops._jit_forest_init(
        state0, X, orders, starts, sizes,
        dist_rowwise=dist_rowwise, leaf_cap=cap, block_rows=block,
    )
    _, cold = timed(run)
    st, warm = timed(run)
    timings[f"leaf_init_{label}"] = {"cold_s": cold, "warm_s": warm, "trees": T}
    print(f"  leaf init {label}: n={n} d={d} trees={T} cap={cap} "
          f"cold {cold:.3f} s, warm {warm:.3f} s", flush=True)
    idx, dist = np.asarray(st.idx), np.asarray(st.dist)
    on, sn, zn = (np.asarray(a) for a in (orders, starts, sizes))
    pos_of = np.argsort(on, axis=1)
    Xh = np.asarray(X)
    worst = 0.0
    for p in np.random.RandomState(seed).choice(n, n_rows, replace=False):
        cand = set()
        for t in range(T):
            s0, sz = sn[t, pos_of[t, p]], zn[t, pos_of[t, p]]
            cand.update(on[t, s0 : s0 + min(sz, cap)].tolist())
        cand = np.fromiter(cand, np.int64)
        diff = Xh[cand].astype(np.float64) - Xh[p].astype(np.float64)
        D = (diff * diff).sum(1)  # direct form: the self pair is exactly 0
        want = np.sort(D)[:K]
        valid = idx[p] >= 0
        got = np.sort(dist[p][valid])
        if len(got) != len(want) or not set(idx[p][valid]) <= set(cand.tolist()):
            raise RuntimeError(f"leaf init row {p}: ids are not its leaf-mates")
        pos = want > 0
        np.testing.assert_allclose(got[pos], want[pos], rtol=RTOL, atol=0)
        # the self pair is exactly 0 in float64; the fp32 gram form leaves
        # at most a few ulps of |x|^2 of cancellation
        bound = 8 * F32_EPS * float((Xh[p] ** 2).sum())
        if np.any(got[~pos] > bound):
            raise RuntimeError(f"leaf init row {p}: self distance {got[~pos]} > {bound}")
        worst = max(worst, float(np.max(np.abs(got[pos] - want[pos]) / want[pos])))
    check(True, f"leaf init {label}: {n_rows} rows match the leaf all-pairs "
                f"oracle within rtol {RTOL} (worst {worst:.2e})")
    return orders


def phase_kernels(bench, X, seed, timings):
    print("phase b: XLA stages vs NumPy references at real widths", flush=True)
    orders = check_leaf_init(X, f"{X.shape[0]}x{X.shape[1]}", timings)
    check_window_sweep(X, orders[0], f"{X.shape[0]}x{X.shape[1]}", timings)
    n784 = min(70_000, X.shape[0])
    X784, _ = bench.make_device_data(n784, 1, 784, seed=seed + 7)
    perm = np.random.RandomState(seed).permutation(n784)
    check_window_sweep(X784, perm, f"{n784}x784", timings)
    del X784
    print(f"  peak device bytes after phase b: {peak_bytes()}", flush=True)


# ---------------------------------------------------------------------------
# phase a: build + query at full size
# ---------------------------------------------------------------------------


def phase_build_query(bench, NNDescent, n, nq, seed, timings):
    from pynndescent_tpu.models import search as search_ops
    from pynndescent_tpu.ops import nndescent as nnd_ops

    print(f"phase a: build + query at {n}x128, k={K}", flush=True)
    train, queries = bench.make_device_data(n, nq, 128, seed=seed)
    stages = [FirstCall(nnd_ops, name) for name in
              ("_jit_forest_init", "_jit_window_sweep", "_jit_descent_loop")]
    search_stage = FirstCall(search_ops, "search_block")
    try:
        def build():
            index = NNDescent(train, n_neighbors=K, random_state=seed, profile=True)
            jax.block_until_ready(index._neighbor_graph)
            return index

        index, cold = timed(build)
        print(f"  build cold (compile + run): {cold:.3f} s; phases "
              f"{index.phase_times_}", flush=True)
        gidx, _ = index.neighbor_graph
        _, prep = timed(lambda: (index.prepare(), index._search_graph)[1])
        (qidx, _), q_cold = timed(lambda: index.query(queries, k=K, epsilon=EPSILON))
        (qidx, _), q_warm = timed(lambda: index.query(queries, k=K, epsilon=EPSILON))
        print(f"  prepare {prep:.3f} s; query cold {q_cold:.3f} s, warm "
              f"{q_warm:.3f} s ({nq / q_warm:.1f} queries/s)", flush=True)
        for st in stages + [search_stage]:
            print(f"  memory_analysis {st.name}: {st.memory()}", flush=True)
    finally:
        for st in stages + [search_stage]:
            st.restore()
    print(f"  peak device bytes after build + query: {peak_bytes()}", flush=True)

    index2, warm = timed(build)
    phases_warm = index2.phase_times_
    _, prep_warm = timed(lambda: (index2.prepare(), index2._search_graph)[1])
    print(f"  build warm: {warm:.3f} s (compile ~{cold - warm:.3f} s); phases "
          f"{phases_warm}; prepare warm {prep_warm:.3f} s", flush=True)
    timings[f"build_{n}"] = {"cold_s": cold, "warm_s": warm,
                           "phases_warm": phases_warm}
    timings[f"query_{n}"] = {"prepare_cold_s": prep, "prepare_warm_s": prep_warm,
                           "cold_s": q_cold, "warm_s": q_warm}

    rs = np.random.RandomState(seed)
    rows = rs.choice(n, min(n, 1024), replace=False)
    g = graph_recall(gidx, train, rows, bench)
    sample = rs.choice(nq, min(nq, 1024), replace=False)
    truth = np.asarray(bench.exact_knn(queries[sample], train, K))
    q = recall(np.asarray(qidx)[sample], truth)
    print(f"  graph recall@10 {g:.4f}; query strict recall@10 {q:.4f}", flush=True)
    check(g >= GRAPH_FLOOR, f"graph recall {g:.4f} >= {GRAPH_FLOOR}")
    check(q >= STRICT_FLOOR, f"query strict recall {q:.4f} >= {STRICT_FLOOR}")
    same = np.array_equal(gidx, index2.neighbor_graph[0])
    check(same, f"two same-seed {n}-row builds give bit-identical graphs")
    return train


def phase_determinism(bench, NNDescent, n, seed, timings):
    print(f"phase c: determinism at {n}x128", flush=True)
    X, _ = bench.make_device_data(n, 1, 128, seed=seed + 3)

    def build():
        index = NNDescent(X, n_neighbors=K, random_state=seed, profile=True)
        return index, jax.block_until_ready(index._neighbor_graph)

    (a, _), cold = timed(build)
    (b, _), warm = timed(build)
    print(f"  build cold {cold:.3f} s, warm {warm:.3f} s; phases "
          f"{b.phase_times_}", flush=True)
    timings[f"build_{n}"] = {"cold_s": cold, "warm_s": warm,
                            "phases_warm": b.phase_times_}
    check(np.array_equal(a.neighbor_graph[0], b.neighbor_graph[0]),
          f"two same-seed {n}-row builds give bit-identical neighbor ids")
    return X


def report_shares(timings, n, n_det):
    """Leaf init and the 12 sweeps as shares of the warm build."""
    b1 = timings.get(f"build_{n}", {}).get("warm_s")
    li = timings.get(f"leaf_init_{n}x128", {}).get("warm_s")
    sw = timings.get(f"sweep_{n}x128", {}).get("warm_s")
    if b1 and li:
        print(f"  share of the {n}-row build: leaf init {li / b1:.3f}", flush=True)
    if b1 and sw:
        print(f"  share of the {n}-row build: 12 sweeps ~ {12 * sw / b1:.3f} "
              f"(12 x one warm window_topm)", flush=True)
    bd = timings.get(f"build_{n_det}", {}).get("warm_s")
    ld = timings.get(f"leaf_init_{n_det}x128", {}).get("warm_s")
    if bd and ld:
        print(f"  share of the {n_det}-row build: leaf init {ld / bd:.3f}", flush=True)


# ---------------------------------------------------------------------------
# phase d: four cards
# ---------------------------------------------------------------------------


def spread_over(arr, devices):
    sharding = getattr(arr, "sharding", None)
    return (
        sharding is not None
        and set(sharding.device_set) == set(devices)
        and not sharding.is_fully_replicated
    )


def phase_four_cards(bench, NNDescent, n, nq, seed, timings):
    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    print(f"phase d: four cards at {n}x128, k={K}", flush=True)
    # the rows update() appends come from the table's own distribution
    n_fresh = max(1, n // 100)
    train, pool = bench.make_device_data(n, nq + n_fresh, 128, seed=seed)
    queries, fresh = pool[:nq], pool[nq:]
    rs = np.random.RandomState(seed)
    rows = rs.choice(n, min(n, 1024), replace=False)
    qs = rs.choice(nq, min(nq, 1024), replace=False)

    def build(**kwargs):
        index = NNDescent(train, n_neighbors=K, random_state=seed, profile=True,
                          **kwargs)
        jax.block_until_ready(index._neighbor_graph)
        return index

    # shard_data first: cards 1-3 have held nothing else yet, so their peak
    # is this build's (card 0 also holds the generated table)
    built = {}
    for label, extra in (("devices=4 shard_data", {"shard_data": True}),
                         ("devices=4", {})):
        index, t = timed(lambda: build(devices=4, **extra))
        print(f"  {label}: build (cold) {t:.3f} s; phases {index.phase_times_}; "
              f"per-card peak bytes {[peak_bytes(d) for d in devs]}", flush=True)
        timings[f"four_{label}"] = {"build_cold_s": t}
        check(spread_over(index._neighbor_graph[0], devs),
              f"{label}: neighbor state sharded over all four cards")
        built[label] = index

    single, t1 = timed(build)
    gi_1, gd_1 = single.neighbor_graph
    print(f"  single-card reference build {t1:.3f} s", flush=True)
    del single
    q_truth = np.asarray(bench.exact_knn(queries[qs], train, K))

    def judge(index, label, X, truth_rows, q_truth):
        gi, gd = index.neighbor_graph
        g = graph_recall(gi, X, truth_rows, bench)
        qi, _ = index.query(queries, k=K, epsilon=EPSILON)
        q = recall(np.asarray(qi)[qs], q_truth)
        print(f"  {label}: graph recall@10 {g:.4f}; query strict recall@10 "
              f"{q:.4f}", flush=True)
        check(g >= GRAPH_FLOOR, f"{label} graph recall {g:.4f} >= {GRAPH_FLOOR}")
        check(q >= STRICT_FLOOR, f"{label} query recall {q:.4f} >= {STRICT_FLOOR}")
        return gi, gd

    for label, index in built.items():
        gi, gd = judge(index, label, train, rows, q_truth)
        # statistical equivalence with the single-card graph (tests/test_parallel.py)
        overlap = recall(gi, gi_1)
        a, b = np.asarray(gd)[:, K - 1], np.asarray(gd_1)[:, K - 1]
        rel = float(np.mean(np.abs(a - b) / np.maximum(b, 1e-12)))
        print(f"  {label}: overlap with the single-card graph {overlap:.4f}, "
              f"mean k-th distance deviation {rel:.5f}", flush=True)
        check(overlap >= 0.9, f"{label} overlap {overlap:.4f} >= 0.9")
        check(rel < 0.02, f"{label} k-th distance deviation {rel:.5f} < 0.02")
    mesh_index = built.pop("devices=4")
    built.clear()

    _, tu = timed(lambda: (mesh_index.update(xs_fresh=np.asarray(fresh)),
                           mesh_index._neighbor_graph)[1])
    full = jnp.concatenate([train, fresh], axis=0)
    print(f"  update(xs_fresh={fresh.shape[0]} rows): {tu:.3f} s", flush=True)
    check(mesh_index._mesh is not None, "update kept the four-card mesh")
    check(spread_over(mesh_index._neighbor_graph[0], devs),
          "devices=4 after update: neighbor state sharded over all four cards")
    # the phase-a floors on 1,024 rows sampled from the grown table; the
    # appended rows (1% of it) are measured apart
    urows = rs.choice(full.shape[0], min(full.shape[0], 1024), replace=False)
    frows = n + rs.choice(fresh.shape[0], min(512, fresh.shape[0]), replace=False)
    uq_truth = np.asarray(bench.exact_knn(queries[qs], full, K))
    judge(mesh_index, "devices=4 after update", full, urows, uq_truth)
    fg = graph_recall(mesh_index.neighbor_graph[0], full, frows, bench)
    print(f"  devices=4 after update: graph recall@10 of {len(frows)} appended "
          f"rows {fg:.4f}", flush=True)
    print(f"  per-card peak bytes {[peak_bytes(d) for d in devs]}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (d)")
    ap.add_argument("--n", type=int, default=1_000_000, help="table rows")
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--det-n", type=int, default=100_000,
                    help="table rows of the determinism phase (c)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    for line in card_lines():
        print(f"card: {line}", flush=True)
    print(f"jax {jax.__version__}; devices {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)

    import bench  # shares the benchmark's generator, oracle and cache setup

    print(f"compile cache: {bench.configure_compile_cache()}", flush=True)
    from pynndescent_tpu import NNDescent

    timings = {}
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(bench, NNDescent, args.n, args.queries, args.seed, timings)
    else:
        phase_kernels(bench, bench.make_device_data(args.n, 1, 128, seed=args.seed)[0],
                      args.seed, timings)
        phase_build_query(bench, NNDescent, args.n, args.queries, args.seed, timings)
        X_det = phase_determinism(bench, NNDescent, args.det_n, args.seed, timings)
        check_leaf_init(X_det, f"{args.det_n}x128", timings, n_rows=64)
        report_shares(timings, args.n, args.det_n)
    print(f"timings: {json.dumps(timings, default=float)}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
