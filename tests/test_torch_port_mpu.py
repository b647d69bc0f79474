"""The port's scattered-query MPU and the VAE's geometry losses against the
JAX package's, on a batch-2 octree of the tiny configuration's depths
(depth 4, full depth 2; ``configs/synthetic_tiny.yaml``):

* ``Octree.search_key`` and ``lookup_table``: hits, misses, keys of the
  other sample, and queries that land in the padded tail, exactly; and
  ``pad_nempty`` / ``depad_nempty``, exactly;
* ``octree_corner_info`` (the search and the ``table=`` path),
  ``mpu_eval``, the analytic ``mpu_eval_grad`` and ``neural_mpu`` at
  random queries and at queries exactly on the lattice corners of depths
  3 and 4 (where ``abs_one``'s derivative at 0 decides the gradient):
  indices and masks exactly, values to 1e-5 and spatial gradients to
  1e-4 (fp32, one blend in another order);
* ``geometry_loss`` for each ``loss_type``: the analytic form against the
  port's three ``torch.func.jvp`` passes and against JAX, every term and
  the gradient in every plane array (1e-4 relative and absolute: a sum
  over ~10^3 corner terms);
* ``octree_split_loss`` (1e-6);
* the corner gather's plan (``mpu_gather_cuda.plan``): each node's slots
  grouped, ascending, with its chunk table; ``_CornerGather`` called
  directly with the kernel's plain version in its backward (against
  ``index``'s, a NaN included, and its ``jvp``), exactly; the kernel's
  wrapper refusing a CPU tensor; and off the card (the CPU, with autograd
  on and under ``no_grad``) the plain gather: no corner-gather backward,
  no launch, ``t[idx]``'s own autograd node, and ``geometry_loss`` and
  ``mpu_interp`` equal bit for bit to a run whose gathers are all the
  plain ``t[idx]``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu.nn import losses as jlosses
from octfusion_tpu.octree.octree import OctreeSpec as JSpec
from octfusion_tpu.octree.octree import build_octree, merge_octrees
from octfusion_tpu.ops import mpu as jmpu
from octfusion_tpu_torch.nn import losses as tlosses
from octfusion_tpu_torch.octree.morton import INVALID_KEY
from octfusion_tpu_torch.ops import mpu as tmpu
from octfusion_tpu_torch.ops import mpu_gather_cuda as mg

from test_torch_port_helpers import np_, port_octree

DEPTH, FD, DS = 4, 2, 3
TOL_VAL = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def octrees():
    """The JAX batch-2 octree of two seeded spheres and its port copy."""
    spec = JSpec.create(DEPTH, FD, 1, finest_cap_per_sample=2048, decay=1.0)
    rng = np.random.RandomState(0)

    @jax.jit
    def build(pts, nrm):
        return merge_octrees([build_octree(pts[i], nrm[i], spec)
                              for i in range(2)])

    v = rng.normal(size=(2, 300, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    radius = np.array([0.55, 0.4])[:, None, None]
    jo = build(jnp.asarray((radius * v).astype(np.float32)),
               jnp.asarray(v.astype(np.float32)))
    assert not np.asarray(jo.overflow).any()
    return jo, port_octree(jo)


def _queries(seed=1, n=160):
    """Random queries in [-0.95, 0.95]^3 and queries on the lattice corners
    of depths 3 and 4, half of each sample -> (pos [N, 3], batch [N])."""
    rng = np.random.RandomState(seed)
    pos = [rng.uniform(-0.95, 0.95, size=(n, 3))]
    for d in (3, 4):
        k = rng.randint(0, 2**d, size=(n // 4, 3))
        pos.append((k + 0.5) * 2.0 / 2**d - 1.0)
    pos = np.concatenate(pos).astype(np.float32)
    pb = (np.arange(pos.shape[0]) % 2).astype(np.int32)
    return pos, pb


def _reg_levels(rng, jo, depth_end):
    return {dd: rng.normal(size=(jo.spec.node_caps[dd], 4)).astype(np.float32)
            for dd in range(FD, depth_end + 1)}


def test_search_key_and_lookup_table_match_jax(octrees):
    jo, to = octrees
    rng = np.random.RandomState(2)
    for d in range(FD, DEPTH + 1):
        nn = int(jo.nnum[d])
        keys, bts = np.asarray(jo.keys[d])[:nn], np.asarray(jo.batch[d])[:nn]
        qk = np.concatenate([
            keys,                                    # hits
            rng.randint(0, 8**d, size=64),           # mostly misses
            keys[:32],                               # the other sample's
            np.full(8, INVALID_KEY),                 # the padded tail
            rng.randint(0, 8**d, size=8)]).astype(np.int32)
        qb = np.concatenate([
            bts, rng.randint(0, 2, size=64), 1 - bts[:32],
            np.full(8, 2), np.full(8, 2)]).astype(np.int32)
        want = jax.jit(lambda o, k, b: o.search_key(k, b, d))(jo, qk, qb)
        got = to.search_key(torch.tensor(qk.astype(np.int64)),
                            torch.tensor(qb.astype(np.int64)), d)
        np.testing.assert_array_equal(np_(got), np_(want), err_msg=str(d))
        assert (np_(got)[:nn] == np.arange(nn)).all()
        assert (np_(got)[-16:] == -1).all()
        np.testing.assert_array_equal(
            np_(to.lookup_table(d)),
            np_(jax.jit(lambda o: o.lookup_table(d))(jo)), err_msg=str(d))


def test_pad_and_depad_nempty_match_jax(octrees):
    jo, to = octrees
    rng = np.random.RandomState(9)
    for d in range(FD, DEPTH):
        data = rng.normal(size=(jo.spec.node_caps[d], 3)).astype(np.float32)
        want = jax.jit(lambda o, x: (o.pad_nempty(x, d),
                                     o.depad_nempty(x, d)))(jo, data)
        got = (to.pad_nempty(torch.tensor(data), d),
               to.depad_nempty(torch.tensor(data), d))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_(g), np_(w), err_msg=str(d))


@pytest.mark.parametrize("use_table", [False, True])
def test_corner_info_and_mpu_match_jax(octrees, use_table):
    jo, to = octrees
    pos, pb = _queries()
    reg = _reg_levels(np.random.RandomState(3), jo, DEPTH)

    @jax.jit
    def jrun(o, pos, pb, reg):
        tables = ({dd: o.lookup_table(dd) for dd in range(FD, DEPTH + 1)}
                  if use_table else None)
        info = [jmpu.octree_corner_info(
            o, dd, pos, pb, table=None if tables is None else tables[dd])
            for dd in range(FD, DEPTH + 1)]
        return (info,
                jmpu.mpu_eval(pos, pb, reg, o, FD, DEPTH, tables=tables),
                jmpu.mpu_eval_grad(pos, pb, reg, o, FD, DEPTH, tables=tables))

    info, (jsdf, jcov), (jsdf2, jgrad) = jrun(jo, pos, pb, reg)
    tpos, tpb = torch.tensor(pos), torch.tensor(pb.astype(np.int64))
    treg = {dd: torch.tensor(r) for dd, r in reg.items()}
    tables = ({dd: to.lookup_table(dd) for dd in range(FD, DEPTH + 1)}
              if use_table else None)
    for dd, (idx, coordsf, w, valid) in zip(range(FD, DEPTH + 1), info):
        got = tmpu.octree_corner_info(
            to, dd, tpos, tpb, table=None if tables is None else tables[dd])
        np.testing.assert_array_equal(np_(got[0]), np_(idx))
        np.testing.assert_array_equal(np_(got[3]), np_(valid))
        np.testing.assert_allclose(np_(got[1]), np_(coordsf), **TOL_VAL)
        np.testing.assert_allclose(np_(got[2]), np_(w), **TOL_VAL)
    sdf, cov = tmpu.mpu_eval(tpos, tpb, treg, to, FD, DEPTH, tables=tables)
    np.testing.assert_allclose(np_(sdf), np_(jsdf), **TOL_VAL)
    np.testing.assert_array_equal(np_(cov), np_(jcov))
    assert np_(cov).any() and not np_(cov).all()
    sdf2, grad = tmpu.mpu_eval_grad(tpos, tpb, treg, to, FD, DEPTH,
                                    tables=tables)
    np.testing.assert_allclose(np_(sdf2), np_(jsdf2), **TOL_VAL)
    np.testing.assert_allclose(np_(grad), np_(jgrad), **TOL_GRAD)
    # the closed form against three forward-mode passes through abs_one
    _, jvp_grad = tlosses.mpu_with_grad(tpos, tpb, treg, to, FD, DEPTH)
    np.testing.assert_allclose(np_(grad), np_(jvp_grad), **TOL_GRAD)
    assert np.abs(np_(grad)).max() > 0


def test_abs_one_derivative_is_one_at_zero():
    """``abs_one``'s derivative is sign(x) with sign(0) = +1 in reverse
    and in forward mode (``torch.abs``'s is 0 at 0)."""
    x = torch.tensor([-2.0, -0.0, 0.0, 3.0], requires_grad=True)
    tmpu.abs_one(x).sum().backward()
    want = np.array([-1.0, 1.0, 1.0, 1.0], np.float32)
    np.testing.assert_array_equal(np_(x.grad), want)
    _, tangent = torch.func.jvp(tmpu.abs_one, (x.detach(),),
                                (torch.ones(4),))
    np.testing.assert_array_equal(np_(tangent), want)
    np.testing.assert_array_equal(
        np_(jax.grad(lambda v: jmpu.abs_one(v).sum())(jnp.asarray(
            np_(x.detach())))), want)


def test_neural_mpu_matches_jax(octrees):
    jo, to = octrees
    pos, pb = _queries(seed=4)
    rng = np.random.RandomState(5)
    voxs = {d: _reg_levels(rng, jo, d) for d in range(DS, DEPTH + 1)}
    want = jax.jit(lambda o, p, b, v: jmpu.neural_mpu(
        p, b, v, o, FD, DS, DEPTH))(jo, pos, pb, voxs)
    got = tmpu.neural_mpu(
        torch.tensor(pos), torch.tensor(pb.astype(np.int64)),
        {d: {dd: torch.tensor(r) for dd, r in v.items()}
         for d, v in voxs.items()}, to, FD, DS, DEPTH)
    assert sorted(got) == sorted(want) == [DS, DEPTH]
    for d in got:
        np.testing.assert_allclose(np_(got[d][0]), np_(want[d][0]),
                                   **TOL_VAL)
        np.testing.assert_array_equal(np_(got[d][1]), np_(want[d][1]))


def _vae_out(rng, jo):
    """A decoder's dict over ``jo``: seeded split logits and planes."""
    return {
        "logits": {d: rng.normal(size=(jo.spec.node_caps[d], 2)).astype(
            np.float32) for d in range(DS, DEPTH + 1)},
        "reg_voxs": {d: {dd: 0.5 * r for dd, r in
                         _reg_levels(rng, jo, d).items()}
                     for d in range(DS, DEPTH + 1)},
        "kl_loss": np.float32(0.37),
    }


def _sdf_gt(rng, n, loss_type):
    sdf = rng.normal(scale=0.2, size=n).astype(np.float32)
    if loss_type == "sdf_grad_loss":
        sdf[::3] = -1.0
    elif loss_type == "possion_grad_loss":
        sdf[::3] = 0.0
        sdf[1::5] = 1.0
    grad = rng.normal(size=(n, 3)).astype(np.float32)
    return sdf, grad


@pytest.mark.parametrize("loss_type", sorted(tlosses.LOSS_FUNCTIONS))
def test_geometry_loss_matches_jax(octrees, loss_type):
    jo, to = octrees
    pos, pb = _queries(seed=6)
    rng = np.random.RandomState(7)
    out = _vae_out(rng, jo)
    sdf_gt, grad_gt = _sdf_gt(rng, pos.shape[0], loss_type)

    @jax.jit
    def jrun(voxs, o):
        def f(voxs):
            ld = jlosses.geometry_loss(
                dict(out, reg_voxs=voxs, octree_out=o), pos, pb, sdf_gt,
                grad_gt, FD, DS, DEPTH, kl_weight=0.1, loss_type=loss_type)
            return ld["loss"], ld
        return jax.value_and_grad(f, has_aux=True)(voxs)

    (_, want), jgrads = jrun(out["reg_voxs"], jo)

    results = {}
    for spatial_grad in ("analytic", "jvp"):
        voxs = {d: {dd: torch.tensor(r, requires_grad=True)
                    for dd, r in v.items()}
                for d, v in out["reg_voxs"].items()}
        tout = {"logits": {d: torch.tensor(v)
                           for d, v in out["logits"].items()},
                "reg_voxs": voxs, "octree_out": to,
                "kl_loss": torch.tensor(out["kl_loss"])}
        ld = tlosses.geometry_loss(
            tout, torch.tensor(pos), torch.tensor(pb.astype(np.int64)),
            torch.tensor(sdf_gt), torch.tensor(grad_gt), FD, DS, DEPTH,
            kl_weight=0.1, loss_type=loss_type, spatial_grad=spatial_grad)
        ld["loss"].backward()
        results[spatial_grad] = (ld, voxs)
        assert sorted(ld) == sorted(want), spatial_grad
        for k in want:
            np.testing.assert_allclose(np_(ld[k]), np_(want[k]), err_msg=k,
                                       **TOL_GRAD)
        for d, v in voxs.items():
            for dd, r in v.items():
                np.testing.assert_allclose(
                    np_(r.grad), np_(jgrads[d][dd]), err_msg=f"{d}/{dd}",
                    **TOL_GRAD)
    (la, va), (lj, vj) = results["analytic"], results["jvp"]
    for k in la:
        np.testing.assert_allclose(np_(la[k]), np_(lj[k]), err_msg=k,
                                   **TOL_GRAD)
    for d in va:
        for dd in va[d]:
            np.testing.assert_allclose(np_(va[d][dd].grad),
                                       np_(vj[d][dd].grad), **TOL_GRAD)
            assert np.abs(np_(va[d][dd].grad)).max() > 0


def test_octree_split_loss_matches_jax(octrees):
    jo, to = octrees
    logits = _vae_out(np.random.RandomState(8), jo)["logits"]
    want = jax.jit(jlosses.octree_split_loss)(logits, jo)
    got = tlosses.octree_split_loss(
        {d: torch.tensor(v) for d, v in logits.items()}, to)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np_(got[k]), np_(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


# ----------------------------------------------------------------------
# the corner gather's plan and its dispatch off the card
# ----------------------------------------------------------------------
def _plan_case(case, octrees):
    """(flat node indices, n_nodes): the fixture octree's depth-4 corners
    of the test queries (misses and out-of-bounds corners clamped to node
    0), or a synthetic depth whose node 0 takes 3000 of 5000 slots
    (several of the kernel's chunks) and whose nodes 5-9 no slot reaches."""
    if case == "octree":
        _, to = octrees
        pos, pb = _queries(seed=10)
        c = tmpu.Corners(to, DEPTH, torch.tensor(pos),
                         torch.tensor(pb.astype(np.int64)))
        return c.idx_c.reshape(-1), c.n_nodes
    gen = torch.Generator().manual_seed(11)
    idx = torch.randint(10, 40, (5000,), generator=gen)
    idx[torch.randperm(5000, generator=gen)[:3000]] = 0
    idx[:4] = torch.arange(1, 5)
    return idx, 40


@pytest.mark.parametrize("case", ["octree", "long_run"])
def test_corner_plan_is_a_stable_grouping(octrees, case):
    """``mpu_gather_cuda.plan``: each node's slots, in ascending order, at
    ``perm[offsets[n]:offsets[n + 1]]``; run lengths equal to the per-node
    counts; ``chunk_ptr`` the prefix sum of ceil(run / CHUNK)."""
    idx, n = _plan_case(case, octrees)
    p = mg.plan(idx, n)
    assert (p.perm.dtype, p.offsets.dtype, p.chunk_ptr.dtype) == (
        torch.int32,) * 3
    counts = torch.bincount(idx, minlength=n)
    assert torch.equal(p.offsets.diff().long(), counts)
    assert int(p.offsets[0]) == 0 and int(p.offsets[-1]) == idx.shape[0]
    for node in range(n):
        run = p.perm[p.offsets[node]:p.offsets[node + 1]].long()
        assert torch.equal(run, torch.nonzero(idx == node)[:, 0]), node
    chunks = (counts + mg.CHUNK - 1) // mg.CHUNK
    assert torch.equal(p.chunk_ptr.long(),
                       torch.cat([torch.zeros(1, dtype=torch.long),
                                  chunks.cumsum(0)]))
    if case == "long_run":
        assert int(chunks[0]) > 1 and int(counts[5:10].sum()) == 0


def test_corner_gather_rules_match_index(octrees, monkeypatch):
    """``_CornerGather`` called directly on the CPU, the kernel's plain
    version (``segment_sum_plain``) in its backward: its value, its
    gradient (against ``index``'s) and its ``jvp`` under
    ``torch.func.jvp``, exactly; one backward counted."""
    monkeypatch.setattr(mg, "segment_sum", mg.segment_sum_plain)
    idx, n = _plan_case("long_run", octrees)
    gen = torch.Generator().manual_seed(12)
    t = torch.randn(n, 4, generator=gen, requires_grad=True)
    ct = torch.randn(idx.shape[0], 4, generator=gen)
    ct[7, 2] = float("nan")
    p = mg.plan(idx, n)
    n0 = tmpu._CornerGather.backward_calls
    out = tmpu._CornerGather.apply(t, idx, p)
    assert torch.equal(out, t[idx])
    (out * ct).sum().backward()
    assert tmpu._CornerGather.backward_calls == n0 + 1
    want = torch.zeros(n, 4).index_add_(0, idx, ct)
    torch.testing.assert_close(t.grad, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(t.grad[idx[7], 2])
    tangent = torch.randn(n, 4, generator=gen)
    _, got = torch.func.jvp(lambda x: tmpu._CornerGather.apply(x, idx, p),
                            (t.detach(),), (tangent,))
    assert torch.equal(got, tangent[idx])


def test_segment_sum_refuses_a_cpu_tensor(octrees):
    """The kernel's wrapper runs on the card only: a CPU gradient raises
    (``Corners.gather`` never sends one there)."""
    idx, n = _plan_case("long_run", octrees)
    with pytest.raises(ValueError, match="CUDA"):
        mg.segment_sum(torch.zeros(idx.shape[0], 4), mg.plan(idx, n), n)


def _autograd_nodes(root):
    """The class names of every node of the autograd graph under
    ``root``."""
    seen, todo, names = set(), [root], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("grad_mode", ["grad", "no_grad"])
def test_corner_gather_off_the_card_is_the_plain_gather(octrees, grad_mode,
                                                        monkeypatch):
    """On the CPU, with autograd recording and under ``no_grad``, the MPU's
    corner gathers take the plain ``t[idx]``: each ``Corners.gather`` is
    ``t[idx_c]`` with ``index``'s own backward node, no
    ``_CornerGather`` node in the loss's graph, no corner-gather backward
    and no kernel launch; ``geometry_loss`` (every term and every plane
    gradient) and ``mpu_interp`` equal bit for bit a run in which every
    gather is replaced by the plain ``t[idx_c]``."""
    jo, to = octrees
    pos, pb = _queries(seed=13)
    rng = np.random.RandomState(14)
    out = _vae_out(rng, jo)
    sdf_gt, grad_gt = _sdf_gt(rng, pos.shape[0], "sdf_reg_loss")
    cols = {dd: rng.normal(size=(jo.spec.node_caps[dd], 3)).astype(np.float32)
            for dd in range(FD, DEPTH + 1)}
    args = [torch.tensor(a) for a in (pos, pb.astype(np.int64), sdf_gt,
                                      grad_gt)]
    track = grad_mode == "grad"
    n0 = (tmpu._CornerGather.backward_calls,
          mg.launches["corner_gather_bwd"])

    for dd in range(FD, DEPTH + 1):
        c = tmpu.Corners(to, dd, args[0], args[1])
        t = torch.tensor(cols[dd], requires_grad=True)
        with torch.set_grad_enabled(track):
            got = c.gather(t)
        assert torch.equal(got, t.detach()[c.idx_c.reshape(-1)]), dd
        assert (type(got.grad_fn).__name__ if track else got.grad_fn) == (
            "IndexBackward0" if track else None), dd

    def run():
        voxs = {d: {dd: torch.tensor(r, requires_grad=track)
                    for dd, r in v.items()}
                for d, v in out["reg_voxs"].items()}
        vals = {dd: torch.tensor(v, requires_grad=track)
                for dd, v in cols.items()}
        vae_out = {"logits": {d: torch.tensor(v)
                              for d, v in out["logits"].items()},
                   "reg_voxs": voxs, "octree_out": to,
                   "kl_loss": torch.tensor(out["kl_loss"])}
        with torch.set_grad_enabled(track):
            ld = tlosses.geometry_loss(vae_out, *args, FD, DS, DEPTH)
            color = tmpu.mpu_interp(args[0], args[1], vals, to, FD, DEPTH)
            total = ld["loss"] + color.square().sum()
            nodes = _autograd_nodes(total.grad_fn)
            if track:
                total.backward()
        grads = [r.grad for v in voxs.values() for r in v.values()] + [
            v.grad for v in vals.values()]
        return ld, color, grads, nodes

    got = run()
    assert (tmpu._CornerGather.backward_calls,
            mg.launches["corner_gather_bwd"]) == n0
    assert "_CornerGatherBackward" not in got[3]
    assert ("IndexBackward0" in got[3]) == track
    monkeypatch.setattr(tmpu.Corners, "gather",
                        lambda self, t: t[self.idx_c.reshape(-1)])
    want = run()
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert (g is None) == (w is None) == (not track)
        if w is not None:
            assert torch.equal(g, w)
