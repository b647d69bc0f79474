"""The port's data parallelism (``octfusion_tpu_torch/parallel``) on the
CPU, in real processes joined to one gloo group
(``parallel/launch.spawn``, as ``tests/test_multihost.py`` runs the JAX
package's two-process runtime), against the JAX package's data-parallel
steps on a 2-device mesh of conftest's virtual CPU devices, at the tiny
size (``configs/synthetic_tiny.yaml``'s values):

* ``shard_batch``: each rank's slices equal the shards JAX's
  ``shard_batch`` places on the device of the same (data, model) index,
  exactly;
* the union lr and hr DP steps (data 2) and the VAE step on the query
  axis (data 1, model 2), from the same weights and each rank's draws
  replicated from JAX's folded key: the averaged loss dict (1e-4) and the
  averaged gradients (read back from JAX's AdamW first moment: 1e-3, and
  each leaf's largest error within 1e-4 of its largest |gradient|, the lr
  U-Net's exact-zero leaves below 1e-5 of the step's largest, as
  ``test_torch_port_train.py``), the same on both ranks bit for bit, as
  are the updated parameters;
* 3 steps from each rank's own generator on its own rows: both ranks end
  with identical parameters and EMA;
* the CLI's loader striping: an epoch's stripes of the data axis are
  disjoint and cover the set, model-axis peers see the same rows;
* the train CLI on 2 ranks (lr stage; the VAE on the query axis), whose
  checkpoints load into a single-process run, and ``--mode generate``
  on 2 ranks writing the same files as 1 rank, byte for byte;
* the 2-stage ``dp_cascade`` against JAX's, with its noise replicated
  from the key (1e-4, as the cascade tests; the 3-stage one is in
  ``test_torch_port_union_3t.py``), and ``make_dp_sample`` against
  ``sample``;
* ``pairwise_cd_emd`` / ``evaluate_point_sets`` with rows split over
  several devices against the unsharded loop (as
  ``tests/test_eval_shard.py``): bit for bit.

Every spawned run has a timeout (``SPAWN_TIMEOUT``); a failing or late
rank kills the others.  JAX is imported inside the tests only, so the
spawned ranks import PyTorch and the port alone."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from octfusion_tpu_torch import config as config_lib
from octfusion_tpu_torch import train as ttrain
from octfusion_tpu_torch.metrics import distances, evaluation
from octfusion_tpu_torch.parallel import dist as pdist
from octfusion_tpu_torch.parallel import launch
from octfusion_tpu_torch.parallel import train_step as pts
from octfusion_tpu_torch.parallel.mesh import Mesh, make_mesh

B = 2
N_POINTS, N_SDF = 2048, 256
SPAWN_TIMEOUT = 400     # seconds for the whole two-rank run
TOL_LOSS = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_SCALE_TOL = 1e-4
NOISE_FLOOR = 1e-5
GEN_COUNT = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "synthetic_tiny.yaml")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cli_config(root, model_axis=1):
    """The tiny YAML of the CLI runs (one loader thread, the mesh's model
    axis), written by :func:`write_cli_configs`."""
    return os.path.join(root, f"cfg_{model_axis}.yaml")


def write_cli_configs(root):
    for model_axis in (1, 2):
        cfg = config_lib.load_config(TINY_YAML)
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, num_workers=1),
            mesh=dataclasses.replace(cfg.mesh, model_axis=model_axis))
        config_lib.dump_config(cfg, _cli_config(root, model_axis))


def _gen_argv(root, logs):
    return ["--model", "union", "--stage", "hr", "--mode", "generate",
            "--count", str(GEN_COUNT), "--config", _cli_config(root),
            "--name", "gen", "--logs_dir", logs, "--device", "cpu",
            "--sampler", "dpmpp", "--sample_steps", "2"]


def _state(net, step):
    return {"params": {n: p.detach().clone()
                       for n, p in net.named_parameters()},
            "ema": {n: e.clone() for n, e in getattr(step, "ema",
                                                     {}).items()}}


def _worker(rank, path, root):
    """One rank of the two-rank run: every scenario, its results back to
    the parent."""
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.models.vae_solver import VAESolver

    torch.set_num_threads(1)
    inp = torch.load(path, weights_only=False)
    cfg = inp["cfg"]
    res = {"world": pdist.world_size(), "rank": pdist.rank()}
    mesh = make_mesh()
    assert mesh == Mesh(2, 1)

    def union(stage):
        st = UnionSolver(cfg, stage_flag=stage, device="cpu")
        st.df.load_state_dict(inp[f"df_{stage}"], strict=True)
        st.vae.load_state_dict(inp["vae"], strict=True)
        return st

    for stage in ("lr", "hr"):
        st = union(stage)
        step = pts.make_union_dp_train_step(st, mesh)
        out = step(pts.shard_batch(inp["batch"], mesh, vae=False),
                   **inp[f"draws_{stage}"][rank])
        res[stage] = dict(out={k: float(v) for k, v in out.items()},
                          grads={n: p.grad.clone() for n, p in
                                 st.df.named_parameters() if p.requires_grad},
                          **_state(st.df, step))

    qmesh = make_mesh(1, 2)
    sv = VAESolver(cfg, device="cpu")
    sv.vae.load_state_dict(inp["vae"], strict=True)
    step = pts.make_vae_dp_train_step(sv, qmesh, 10)
    out = step(pts.shard_batch(inp["vbatch"], qmesh, vae=True),
               eps=inp["draws_vae"][rank])
    res["vae"] = dict(out={k: float(v) for k, v in out.items()},
                      grads={n: p.grad.clone() for n, p in
                             sv.vae.named_parameters()},
                      **_state(sv.vae, step))

    # 3 steps from the ranks' own generators on their own rows; rank 1
    # starts from other weights, which the step's broadcast replaces
    st = union("hr")
    if rank == 1:
        with torch.no_grad():
            for p in st.df.parameters():
                p.add_(1.0)
    step = pts.make_union_dp_train_step(st, mesh, seed=7)
    losses = [float(step(pts.shard_batch(inp["batch"], mesh,
                                         vae=False))["loss"])
              for _ in range(3)]
    res["three"] = dict(losses=losses, **_state(st.df, step))

    quiet = lambda *a, **k: None    # noqa: E731
    res["stripes"] = {}
    for shape in ((2, 1), (1, 2)):
        lcfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, batch_size=2, shuffle=True))
        dl = ttrain.striped_loader(range(8), lcfg, make_mesh(*shape), quiet)
        it = iter(dl.sampler)
        res["stripes"][shape] = dict(batch_size=dl.batch_size,
                                     len=len(dl),
                                     idx=[next(it) for _ in range(8)])

    logs = os.path.join(root, "two")
    res["generated"] = ttrain.main(_gen_argv(root, logs))
    stats = ttrain.main(["--model", "union", "--stage", "lr", "--name", "lr",
                         "--max_steps", "2", "--config", _cli_config(root),
                         "--logs_dir", logs, "--device", "cpu"])
    res["cli_lr_loss"] = stats["loss"]
    stats = ttrain.main(["--model", "vae", "--name", "vae", "--max_steps",
                         "2", "--config", _cli_config(root, model_axis=2),
                         "--logs_dir", logs, "--device", "cpu"])
    res["cli_vae_loss"] = stats["loss"]
    return res


def _fold(key, di, mi):
    import jax
    return jax.random.fold_in(jax.random.fold_in(key, di), mi)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX DP steps on a 2-device mesh and the port's on two spawned
    gloo ranks, from the same weights, batches and per-rank draws."""
    import jax
    import jax.numpy as jnp

    from octfusion_tpu.models.common import TrainState
    from octfusion_tpu.models.union_solver import UnionSolver as JSolver
    from octfusion_tpu.models.vae_solver import VAESolver as JVAESolver
    from octfusion_tpu.nn.unet_union import UNetUnion as JUNetUnion
    from octfusion_tpu.parallel import train_step as jpts
    from octfusion_tpu.parallel.mesh import make_mesh as jmake_mesh
    from octfusion_tpu.utils import torch_convert as tc
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.utils import params as bridge
    from octfusion_tpu_torch.utils.shapes import (lumpy_sphere_sdf_samples,
                                                  lumpy_spheres)

    import torch_ref_unet as tru
    import torch_ref_vae as tref
    from test_torch_port_helpers import TINY, jcfg, np_, tcfg, tiny_config
    from test_torch_port_train import HR_CFG, LR_CFG, _first_moment

    root = str(tmp_path_factory.mktemp("dp"))
    cj, ct = tiny_config(jcfg), tiny_config(tcfg)
    rng = np.random.RandomState(0)
    lr_params = tc.convert_unet_lr(tru.lr_make_state_dict(rng, LR_CFG),
                                   LR_CFG["channel_mult"],
                                   LR_CFG["attention_resolutions"])
    hr_params = tc.convert_unet_hr(
        tru.hr_make_state_dict(rng, HR_CFG, in_channels=2, out_channels=2,
                               lr_model_channels=8),
        HR_CFG["channel_mult"], HR_CFG["num_res_blocks"])
    m = TINY["model"]
    arch = (m["depth"], m["depth_stop"], m["depth_out"], m["resblk_num"])
    vae_params = tc.convert_vae(tref.make_state_dict(
        rng, *arch[:3], m["resblk_num"], m["channels"], m["embed_dim"]),
        *arch)
    params = {"lr": {"params": {"unet_lr": lr_params}},
              "hr": {"params": {"unet_lr": lr_params,
                                "unet_hr": hr_params}}}
    pts_, nrm = lumpy_spheres(B, N_POINTS, seed=3)
    batch = {"points": pts_, "normals": nrm}
    vbatch = {**batch, "label": torch.zeros(B, dtype=torch.int64),
              **lumpy_sphere_sdf_samples(B, N_SDF, seed=3,
                                         points_per_shape=N_POINTS)}
    key = jax.random.PRNGKey(5)
    jmesh = jmake_mesh(data=2, model=1)
    inp = {"cfg": ct, "batch": batch, "vbatch": vbatch,
           "vae": bridge.vae_state_dict(vae_params, *arch)}
    ref = {}
    code1 = UnionSolver(ct, device="cpu").code_shape(1)

    @jax.jit
    def lr_draws(k):
        tkey, nkey = jax.random.split(k)
        return dict(times=jax.random.uniform(tkey, (1,)),
                    noise=jax.random.normal(nkey, (1, 4, 4, 4, 8)))

    @jax.jit
    def hr_draws(k):
        ekey, dkey = jax.random.split(k)
        tkey, nkey = jax.random.split(dkey)
        return dict(eps=jax.random.normal(ekey, code1),
                    times=jax.random.uniform(tkey, (1,)),
                    noise=jax.random.normal(nkey, code1))

    draw_fns = {"lr": lr_draws, "hr": hr_draws}
    jb = {k: np_(v) for k, v in batch.items()}
    for stage in ("lr", "hr"):
        sj = JSolver(cj, stage_flag=stage)
        sj.df = JUNetUnion(dataclasses.replace(sj.union_cfg,
                                               use_checkpoint=False), stage)
        p = params[stage]
        tx = sj.make_optimizer()
        state = TrainState(step=jnp.asarray(0, jnp.int32), params=p,
                           opt_state=tx.init(p), ema_params=p)
        new, ld = jpts.make_union_dp_train_step(sj, jmesh)(
            state, vae_params if stage == "hr" else None,
            jpts.shard_batch(jb, jmesh, vae=False), key)
        # the trainable U-Net's gradients (the hr stage freezes unet_lr)
        mu = _first_moment(new.opt_state)["params"][f"unet_{stage}"]
        grads = {"params": {f"unet_{stage}": jax.tree_util.tree_map(
            lambda v: np_(v) / np.float32(0.1), mu)}}
        st = UnionSolver(ct, stage_flag=stage, device="cpu")
        inp[f"df_{stage}"] = bridge.union_state_dict(p, st.union_cfg)
        ref[stage] = dict(ld={k: float(v) for k, v in ld.items()},
                          grads=bridge.union_state_dict(grads, st.union_cfg))
        inp[f"draws_{stage}"] = [
            {k: torch.tensor(np_(v)) for k, v in
             draw_fns[stage](_fold(key, r, 0)).items()} for r in range(2)]

    sv = JVAESolver(cj)
    from octfusion_tpu_torch.models.vae_solver import VAESolver
    vcode = VAESolver(ct, device="cpu").code_shape(B)
    tx = sv.make_optimizer(10)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=vae_params,
                       opt_state=tx.init(vae_params))
    qmesh = jmake_mesh(data=1, model=2)
    new, ld = jpts.make_vae_dp_train_step(sv, qmesh, 10)(
        state, jpts.shard_batch({k: np_(v) for k, v in vbatch.items()},
                                qmesh, vae=True), key)
    grads = jax.tree_util.tree_map(lambda v: np_(v) / np.float32(0.1),
                                   _first_moment(new.opt_state))
    ref["vae"] = dict(ld={k: float(v) for k, v in ld.items()},
                      grads=bridge.vae_state_dict(grads, *arch))
    inp["draws_vae"] = [torch.tensor(np_(jax.jit(
        lambda k: jax.random.normal(k, vcode))(_fold(key, 0, r))))
        for r in range(2)]

    path = os.path.join(root, "inputs.pt")
    torch.save(inp, path)
    write_cli_configs(root)
    got = launch.spawn(_worker, 2, args=(path, root), backend="gloo",
                       device="cpu", timeout=SPAWN_TIMEOUT)
    return dict(ref=ref, got=got, root=root, inp=inp)


def _check_step(dp, what, prefix):
    r0, r1 = dp["got"][0][what], dp["got"][1][what]
    want = dp["ref"][what]
    assert r0["out"] == r1["out"]
    assert sorted(r0["out"]) == sorted(want["ld"])
    for k, v in want["ld"].items():
        np.testing.assert_allclose(r0["out"][k], v, err_msg=k, **TOL_LOSS)
    assert sorted(r0["grads"]) == sorted(want["grads"])
    assert all(n.startswith(prefix) for n in r0["grads"])
    floor = NOISE_FLOOR * max(np.abs(_np(g)).max()
                              for g in want["grads"].values())
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n
        ref = _np(want["grads"][n]).reshape(g.shape)
        np.testing.assert_allclose(_np(g), ref, err_msg=n, **GRAD_TOL)
        err, scale = np.abs(_np(g) - ref).max(), np.abs(ref).max()
        if scale <= floor:
            assert np.abs(_np(g)).max() <= floor, (n, scale, floor)
            continue
        assert err <= GRAD_SCALE_TOL * scale, (n, err, scale)
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    for n, e in r0["ema"].items():
        assert torch.equal(e, r1["ema"][n]), n


def test_two_ranks_joined_one_group(dp):
    assert [(r["rank"], r["world"]) for r in dp["got"]] == [(0, 2), (1, 2)]


@pytest.mark.parametrize("stage", ["lr", "hr"])
def test_union_dp_step_matches_jax(dp, stage):
    _check_step(dp, stage, "unet_lr." if stage == "lr" else "unet_hr.")


def test_vae_dp_step_on_the_query_axis_matches_jax(dp):
    _check_step(dp, "vae", "")


def test_ranks_hold_identical_parameters_after_three_steps(dp):
    r0, r1 = dp["got"][0]["three"], dp["got"][1]["three"]
    assert r0["losses"] == r1["losses"]
    assert np.isfinite(r0["losses"]).all()
    for part in ("params", "ema"):
        assert sorted(r0[part]) == sorted(r1[part])
        for n, v in r0[part].items():
            assert torch.equal(v, r1[part][n]), (part, n)
    # the steps moved the hr U-Net, and rank 1's own start was replaced
    start = dp["inp"]["df_hr"]
    assert any(not torch.equal(r0["params"][n], start[n])
               for n in r0["params"] if n.startswith("unet_hr."))
    for n, v in r0["params"].items():
        if n.startswith("unet_lr."):
            assert torch.equal(v, start[n].reshape(v.shape)), n


def test_loader_stripes(dp):
    """Data axis 2: each rank one row a step, the two stripes of an epoch
    disjoint and covering the 8 samples; model axis 2: both ranks the
    whole batch, the same rows."""
    a, b = (r["stripes"][(2, 1)] for r in dp["got"])
    assert a["batch_size"] == b["batch_size"] == 1
    assert a["len"] == b["len"] == 4
    for e in (slice(0, 4), slice(4, 8)):
        assert not set(a["idx"][e]) & set(b["idx"][e])
        assert set(a["idx"][e]) | set(b["idx"][e]) == set(range(8))
    a, b = (r["stripes"][(1, 2)] for r in dp["got"])
    assert a["batch_size"] == b["batch_size"] == 2
    assert a["idx"] == b["idx"] and sorted(a["idx"]) == list(range(8))


def test_cli_trains_on_two_ranks(dp):
    """The 2-rank CLI runs (lr at data 2; the VAE at model 2) trained with
    finite, rank-averaged losses, and their rank-0 checkpoints load into
    a single-process run."""
    from octfusion_tpu_torch.models.union_solver import UnionSolver
    from octfusion_tpu_torch.models.vae_solver import VAESolver
    from octfusion_tpu_torch.utils import ckpt as ckpt_lib

    r0, r1 = dp["got"]
    for k in ("cli_lr_loss", "cli_vae_loss"):
        assert len(r0[k]) == 2 and np.isfinite(r0[k]).all()
        assert r0[k] == r1[k]
    cfg = config_lib.load_config(TINY_YAML)
    logs = os.path.join(dp["root"], "two")
    for name, step in (
            ("lr", UnionSolver(cfg, stage_flag="lr",
                               device="cpu").make_train_step()),
            ("vae", VAESolver(cfg, device="cpu").make_train_step(2))):
        tree = ckpt_lib.restore(os.path.join(logs, name, "ckpt",
                                             "steps-latest"))
        ttrain.restore_training(step, tree)
        assert step.step == 2


def test_cli_generation_on_two_ranks_writes_what_one_rank_does(dp):
    """On one intra-op thread, as each rank runs: the CPU's summation
    order may follow the thread count."""
    one = os.path.join(dp["root"], "one")
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = ttrain.main(_gen_argv(dp["root"], one))
    finally:
        torch.set_num_threads(saved)
    striped = dp["got"][0]["generated"] + dp["got"][1]["generated"]
    # rank r made shapes r, r + 2, ...
    assert [os.path.basename(p) for p in dp["got"][0]["generated"]] == [
        "0.obj", "2.obj"]
    assert sorted(map(os.path.basename, striped)) == sorted(
        map(os.path.basename, single)) == [f"{i}.obj"
                                           for i in range(GEN_COUNT)]
    for p in single:
        q = os.path.join(dp["root"], "two", "gen", "results_airplane",
                         os.path.basename(p))
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read(), p


# ----------------------------------------------------------------------
# in one process
# ----------------------------------------------------------------------
def test_shard_batch_matches_jax_specs():
    """A 2 x 2 mesh: each (data, model) rank's slices against the shard
    JAX's ``shard_batch`` places on that device of its mesh."""
    from octfusion_tpu.parallel import train_step as jpts
    from octfusion_tpu.parallel.mesh import make_mesh as jmake_mesh

    rng = np.random.RandomState(4)
    batch = {"points": rng.normal(size=(4, 6, 3)).astype(np.float32),
             "normals": rng.normal(size=(4, 6, 3)).astype(np.float32),
             "label": np.arange(4, dtype=np.int32),
             "pos": rng.normal(size=(4, 8, 3)).astype(np.float32),
             "sdf": rng.normal(size=(4, 8)).astype(np.float32),
             "grad": rng.normal(size=(4, 8, 3)).astype(np.float32),
             "filename": ["a", "b", "c", "d"]}
    jmesh = jmake_mesh(data=2, model=2)
    devices = np.asarray(jmesh.devices)
    mesh = Mesh(2, 2)
    for vae in (True, False):
        want = jpts.shard_batch(batch, jmesh, vae=vae)
        for r in range(4):
            got = pts.shard_batch(batch, mesh, vae, rank=r)
            assert sorted(got) == sorted(want)
            dev = devices[mesh.coords(r)]
            for k, arr in want.items():
                shard = [s for s in arr.addressable_shards
                         if s.device == dev][0]
                np.testing.assert_array_equal(got[k], np.asarray(shard.data),
                                              err_msg=f"{k} rank {r}")
    # a rank-striped loader's rows: only the queries split
    rows = pts.shard_batch(batch, mesh, True, rank=3, rows_local=True)
    np.testing.assert_array_equal(rows["points"], batch["points"])
    np.testing.assert_array_equal(rows["pos"], batch["pos"][:, 4:])


def test_mesh_and_single_process_defaults(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "OCTFUSION_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.requested() is None
    assert not pdist.maybe_initialize("cpu")
    assert (pdist.rank(), pdist.world_size(), pdist.is_main()) == (0, 1, True)
    pdist.barrier()
    assert make_mesh() == Mesh(1, 1)
    assert make_mesh(-1, 2, world=4) == Mesh(2, 2)
    assert Mesh(2, 2).coords(3) == (1, 1)
    with pytest.raises(ValueError, match="world has 4"):
        make_mesh(3, 1, world=4)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(-1, 3, world=4)
    monkeypatch.setenv("OCTFUSION_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("OCTFUSION_NUM_PROCESSES", "2")
    monkeypatch.setenv("OCTFUSION_PROCESS_ID", "1")
    assert pdist.requested() == ("tcp://127.0.0.1:1234", 2, 1, 1)
    monkeypatch.setenv("OCTFUSION_COORDINATOR", "auto")
    with pytest.raises(RuntimeError, match="torchrun"):
        pdist.requested()


def test_backend_follows_the_hosts_cards(monkeypatch):
    """NCCL for a rank with a card of its own; gloo on the CPU and where
    a host's ranks outnumber its cards, which they then share."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(pdist, "_local_rank", 0)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert pdist.default_backend("cpu") == "gloo"
    assert pdist.default_backend("cuda") == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert pdist.default_backend("cuda:1") == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert pdist.default_backend("cuda") == "gloo"
    # without LOCAL_WORLD_SIZE (the JAX package's variables) the local
    # rank tells
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setattr(pdist, "_local_rank", 2)
    assert pdist.default_backend("cuda") == "gloo"


@pytest.mark.parametrize("world", [1, 2, 3])
def test_cli_generation_stripes_by_rank(world):
    """The CLIs' rule, ``stripe`` over a mesh of every rank on the data
    axis: rank r makes r, r + W, ..., and the ranks cover each index
    once."""
    mesh = make_mesh(world=world)
    shares = [pts.stripe(range(7), mesh, rank=r) for r in range(world)]
    assert shares == [list(range(r, 7, world)) for r in range(world)]
    assert sorted(sum(shares, [])) == list(range(7))


def test_dp_cascade_matches_jax():
    """The 2-stage ``dp_cascade`` of one shape against JAX's, the port's
    noise the streams JAX draws from the split key (the 3-stage one is in
    ``test_torch_port_union_3t.py``)."""
    import jax

    from octfusion_tpu_torch.octree.dual_graph import GraphSpec

    from test_torch_port_helpers import union_solvers
    from test_torch_port_union_3t import (STEPS, assert_dp_cascade_equal,
                                          jax_stream)

    sj, st, params, vae, _ = union_solvers()
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, v, k: sj.dp_cascade(p, v, k, steps=STEPS))(
        params, vae, key)
    k1, k2 = jax.jit(jax.random.split)(key)
    lr = jax_stream(k1, (1, 4, 4, 4, 8), STEPS).transpose(0, 1, 5, 2, 3, 4)
    hr = jax_stream(k2, (GraphSpec(st.spec1, st.edge_factor).g_cap(3), 2),
                    STEPS)
    assert_dp_cascade_equal(st.dp_cascade(steps=STEPS, lr_noise=lr,
                                          hr_noise=hr), want)


def test_make_dp_sample_is_the_cascade_per_shape():
    """One process (a 1 x 1 mesh): shape i's grid is ``sample``'s from
    the generator of (seed, i), bit for bit."""
    from octfusion_tpu_torch.generate import shape_seed
    from octfusion_tpu_torch.models.union_solver import UnionSolver

    cfg = config_lib.load_config(TINY_YAML)
    torch.manual_seed(0)
    st = UnionSolver(cfg, device="cpu")
    grids = pts.make_dp_sample(st, make_mesh(world=1), steps=2,
                               resolution=16)([4, 7], seed=3)
    assert sorted(grids) == [4, 7]
    for i, g in grids.items():
        gen = torch.Generator().manual_seed(shape_seed(3, i))
        want = st.sample(steps=2, resolution=16, generator=gen)["sdfs"][0]
        assert torch.equal(g, want), i
    assert pts.stripe(range(7), Mesh(3, 2), rank=3) == [1, 4]


def _clouds(s, r, n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.uniform(-0.5, 0.5, (s, n, 3)).astype(np.float32)),
            torch.tensor(rng.uniform(-0.5, 0.5, (r, n, 3)).astype(np.float32)))


@pytest.mark.parametrize("s,r", [(16, 16), (13, 9)])   # odd: the pad path
def test_sharded_pairwise_equals_unsharded(s, r):
    a, b = _clouds(s, r, seed=3)
    cd1, em1 = distances.pairwise_cd_emd(a, b, batch=4, emd=True,
                                         row_block=2)
    for devices in (["cpu", "cpu"], ["cpu"] * 3):
        cd, em = distances.pairwise_cd_emd(a, b, batch=4, emd=True,
                                           row_block=2,
                                           shard_devices=devices)
        np.testing.assert_array_equal(cd, cd1)
        np.testing.assert_array_equal(em, em1)
    # "auto" without several cards is the unsharded loop
    cd, _ = distances.pairwise_cd_emd(a, b, batch=4, emd=False,
                                      row_block=2, shard_devices="auto")
    np.testing.assert_array_equal(cd, cd1)


def test_evaluate_point_sets_sharded_identical_metrics():
    a, b = _clouds(12, 12, n=48, seed=7)
    m1 = evaluation.evaluate_point_sets(a, b, batch=4, emd=True,
                                        device="cpu")
    m2 = evaluation.evaluate_point_sets(a, b, batch=4, emd=True,
                                        device="cpu",
                                        shard_devices=["cpu", "cpu"])
    assert m1 == m2
