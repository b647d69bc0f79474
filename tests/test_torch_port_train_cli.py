"""The port's training CLI (``python -m octfusion_tpu_torch.train``) and
what it is made of, on the CPU at ``configs/synthetic_tiny.yaml`` size
(the loop against the JAX package's is ``test_torch_port_train_loop.py``):

* resume at the loop level, for each stage: 4 steps straight against 2
  steps, a checkpoint saved and restored (``weights_only``) into a fresh
  solver, then 2 more, on the same batches and draws, under PyTorch's
  deterministic kernels: the parameters, the EMA, AdamW's moments and the
  learning rate equal bit for bit; a VAE
  resumed under another ``total_steps`` decays from the restored step
  under the new one;
* ``utils/params.union_checkpoint`` writes the EMA under
  ``ema_df_unet_*`` (it wrote the live weights there), and
  ``graft_union_checkpoint`` copies an lr run's weights and EMA;
* the CLI end to end in-process: VAE, lr (with ``--profile``), then hr
  train with ``--vq_ckpt`` and ``--pretrain_ckpt`` (display evals on), a
  resumed longer VAE run, the generate modes of union (hr and lr) and
  vae, a conditional model's labels, the 3-stage model (``--model
  union_3t``: lr, hr, feature with their grafts, generate), and the
  2-stage model's feature stage and the card-only default raising;
* ``OverflowMonitor`` and ``StallWatchdog`` (as ``tests/
  test_overflow_monitor.py`` and ``tests/test_watchdog.py`` hold the JAX
  package's)."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from octfusion_tpu_torch import config as config_lib
from octfusion_tpu_torch import train as ttrain
from octfusion_tpu_torch.data import dataset as tds
from octfusion_tpu_torch.data import loader as tloader
from octfusion_tpu_torch.models.union_3t_solver import Union3TSolver
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.models.vae_solver import VAESolver
from octfusion_tpu_torch.utils import ckpt as ckpt_lib
from octfusion_tpu_torch.utils import params as params_lib
from octfusion_tpu_torch.utils.overflow import OverflowMonitor
from octfusion_tpu_torch.utils.watchdog import StallWatchdog

from test_torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "synthetic_tiny.yaml")
B = 2
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def tiny_cfg():
    cfg = config_lib.load_config(TINY_YAML)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, num_workers=1))


@pytest.fixture(scope="module")
def batches():
    """4 loader batches of the tiny config's synthetic data."""
    cfg = tiny_cfg()
    it = iter(tloader.DataLoader(tds.get_dataset(cfg.data), B, True, 0, 2))
    try:
        return [next(it) for _ in range(4)]
    finally:
        it.close()


def make_step(stage, seed):
    """A fresh solver's train step; its weights seeded by ``seed``, but
    the hr stage's frozen VAE from seed 0 (what ``--vq_ckpt`` gives every
    run)."""
    cfg = tiny_cfg()
    torch.manual_seed(seed)
    if stage == "vae":
        return VAESolver(cfg, device="cpu").make_train_step(10)
    solver = UnionSolver(cfg, stage_flag=stage, device="cpu")
    torch.manual_seed(0)
    solver.vae.load_state_dict(
        UnionSolver(cfg, stage_flag=stage, device="cpu").vae.state_dict())
    return solver.make_train_step()


def draws(stage, step, n):
    gen = torch.Generator().manual_seed(5)
    cs = step.solver.code_shape(B)
    out = []
    for _ in range(n):
        if stage == "vae":
            out.append({"eps": torch.randn(cs, generator=gen)})
            continue
        shape = cs if stage == "hr" else (B, 4, 4, 4, 8)
        d = {"times": torch.rand(B, generator=gen),
             "noise": torch.randn(shape, generator=gen)}
        if stage == "hr":
            d["eps"] = torch.randn(cs, generator=gen)
        out.append(d)
    return out


def train_state(step):
    """Every tensor of the run's state, by name."""
    net = step.solver.vae if isinstance(step.solver, VAESolver) \
        else step.solver.df
    out = {f"param/{n}": p.detach().clone()
           for n, p in net.named_parameters()}
    for n, e in getattr(step, "ema", {}).items():
        out[f"ema/{n}"] = e.clone()
    for gi, group in enumerate(step.optimizer.param_groups):
        for pi, p in enumerate(group["params"]):
            for k, v in step.optimizer.state[p].items():
                out[f"adam/{gi}.{pi}/{k}"] = torch.as_tensor(v).clone()
    out["lr"] = torch.tensor(step.optimizer.param_groups[0]["lr"],
                             dtype=torch.float64)
    return out


@pytest.fixture
def deterministic():
    """PyTorch's deterministic kernels for the test: the CPU's parallel
    ``index_add_`` adds in a varying order, so two straight runs of the
    graph stages differ in the last bit without it."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("stage", ["vae", "lr", "hr"])
def test_resume_is_bit_exact(stage, batches, tmp_path, deterministic):
    straight = make_step(stage, 1)
    d = draws(stage, straight, 4)
    ttrain.train_loop(straight, iter(batches), 4, draws=lambda it: d[it])

    first = make_step(stage, 1)
    ttrain.train_loop(first, iter(batches[:2]), 2, draws=lambda it: d[it])
    path = ckpt_lib.save(str(tmp_path), ttrain.training_checkpoint(first), 2)
    resumed = make_step(stage, 2)      # other weights: all must be restored
    ttrain.restore_training(resumed, ckpt_lib.restore(path))
    assert resumed.step == 2
    ttrain.train_loop(resumed, iter(batches[2:]), 4, start=2,
                      draws=lambda it: d[it])

    want, got = train_state(straight), train_state(resumed)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("adam/") for k in got)
    assert any(k.startswith("ema/") for k in got) == (stage != "vae")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert resumed.step == straight.step == 4


def test_vae_resume_under_new_total_steps(batches, tmp_path):
    """The poly decay goes on from the restored step under the new run's
    total_steps, as optax's schedule does."""
    step = make_step("vae", 1)
    d = draws("vae", step, 2)
    ttrain.train_loop(step, iter(batches), 2, draws=lambda it: d[it])
    path = ckpt_lib.save(str(tmp_path), ttrain.training_checkpoint(step), 2)
    longer = make_step("vae", 1).solver.make_train_step(20)
    ttrain.restore_training(longer, ckpt_lib.restore(path))
    lr = tiny_cfg().train.lr
    want = lr * (1 - 2 / 20) ** 0.9
    assert longer.optimizer.param_groups[0]["lr"] == pytest.approx(want,
                                                                   rel=1e-12)
    assert longer.scheduler.get_last_lr()[0] == pytest.approx(want, rel=1e-12)
    longer.scheduler.step()
    assert longer.optimizer.param_groups[0]["lr"] == pytest.approx(
        lr * (1 - 3 / 20) ** 0.9, rel=1e-12)


def test_union_checkpoint_holds_the_ema(batches):
    """After a step the EMA differs from the live weights, and the
    checkpoint's ``ema_df_unet_hr`` is the EMA, not the live weights."""
    step = make_step("hr", 1)
    d = draws("hr", step, 1)
    ttrain.train_loop(step, iter(batches), 1, draws=lambda it: d[it])
    tree = params_lib.union_checkpoint(step.solver.df, step.ema)
    live, ema = tree["df_unet_hr"], tree["ema_df_unet_hr"]
    assert sorted(live) == sorted(ema)
    assert any(not torch.equal(live[k], ema[k]) for k in live)
    for k, v in ema.items():
        assert torch.equal(v, step.ema[f"unet_hr.{k}"]), k
    assert params_lib.union_ema(tree).keys() == step.ema.keys()
    plain = params_lib.union_checkpoint(step.solver.df)
    for k in live:
        assert torch.equal(plain["ema_df_unet_hr"][k], live[k])


def test_union_checkpoint_raises_for_a_missing_ema_entry():
    """A parameter missing from ``ema`` raises instead of being written
    with its live weight; buffers are taken live."""
    step = make_step("hr", 1)
    ema = dict(step.ema)
    name = next(iter(ema))
    del ema[name]
    with pytest.raises(KeyError, match=name):
        params_lib.union_checkpoint(step.solver.df, ema)


def test_graft_copies_weights_and_ema(batches):
    lr_step = make_step("lr", 3)
    d = draws("lr", lr_step, 1)
    ttrain.train_loop(lr_step, iter(batches), 1, draws=lambda it: d[it])
    tree = ttrain.training_checkpoint(lr_step)
    hr_step = make_step("hr", 4)
    assert params_lib.graft_union_checkpoint(
        hr_step.solver.df, hr_step.ema, tree) == ["lr"]
    for k, v in hr_step.solver.df.unet_lr.state_dict().items():
        assert torch.equal(v, tree["df_unet_lr"][k]), k
        assert torch.equal(hr_step.ema[f"unet_lr.{k}"],
                           tree["ema_df_unet_lr"][k]), k
    assert any(not torch.equal(tree["df_unet_lr"][k],
                               tree["ema_df_unet_lr"][k])
               for k in tree["df_unet_lr"])


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def _cli(root, *argv):
    return ttrain.main([*argv, "--config", os.path.join(root, "cfg.yaml"),
                        "--logs_dir", root, "--device", "cpu"])


def _obj_faces(path):
    with open(path) as fh:
        return sum(ln.startswith("f ") for ln in fh)


def test_cli_trains_every_stage_and_generates(tmp_path, capsys):
    root = str(tmp_path)
    cfg = tiny_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, print_freq=1, save_latest_freq=1, display_freq=2,
        ckpt_num=2))
    config_lib.dump_config(cfg, os.path.join(root, "cfg.yaml"))

    stats = _cli(root, "--model", "vae", "--name", "vae", "--max_steps", "2")
    assert len(stats["loss"]) == 2 and np.isfinite(stats["loss"]).all()
    out = capsys.readouterr().out
    assert "[*] trained vae on cpu: steps=2 " in out
    assert os.path.exists(os.path.join(root, "vae", "train_temp",
                                       "recon_2.obj"))
    vae_ckpt = os.path.join(root, "vae", "ckpt", "steps-latest")
    assert sorted(ckpt_lib.restore(vae_ckpt)) == ["autoencoder",
                                                  "train_state"]
    # a longer run of the same directory resumes at the saved step
    stats = _cli(root, "--model", "vae", "--name", "vae", "--max_steps", "3")
    assert f"resumed from {vae_ckpt} at step 2" in capsys.readouterr().out
    assert len(stats["loss"]) == 1
    assert ckpt_lib.restore(vae_ckpt)["train_state"]["step"] == 3
    ckpts = sorted(os.listdir(os.path.join(root, "vae", "ckpt")))
    assert ckpts == ["steps-2.pth", "steps-3.pth", "steps-latest"]

    _cli(root, "--model", "union", "--stage", "lr", "--name", "lr",
         "--max_steps", "2", "--profile", "1")
    with open(os.path.join(root, "lr", "profile", "trace.json")) as fh:
        assert '"octf.train.forward_backward"' in fh.read()
    lr_ckpt = ckpt_lib.restore(os.path.join(root, "lr", "ckpt",
                                            "steps-latest"))
    assert sorted(lr_ckpt) == ["df_unet_lr", "ema_df_unet_lr", "train_state"]

    _cli(root, "--model", "union", "--stage", "hr", "--name", "hr",
         "--max_steps", "2", "--vq_ckpt", vae_ckpt, "--pretrain_ckpt",
         os.path.join(root, "lr", "ckpt", "steps-latest"))
    out = capsys.readouterr().out
    assert "[*] grafted unet_lr from" in out
    assert "[*] loaded VAE weights from" in out
    assert os.path.exists(os.path.join(root, "hr", "train_temp",
                                       "sample_2.obj"))
    hr_ckpt = ckpt_lib.restore(os.path.join(root, "hr", "ckpt",
                                            "steps-latest"))
    # the frozen lr U-Net is the lr run's, bit for bit
    for k, v in lr_ckpt["df_unet_lr"].items():
        assert torch.equal(hr_ckpt["df_unet_lr"][k], v), k
    assert any(not torch.equal(hr_ckpt["df_unet_hr"][k],
                               hr_ckpt["ema_df_unet_hr"][k])
               for k in hr_ckpt["df_unet_hr"])

    for argv in (("--model", "union", "--stage", "hr", "--name", "hr",
                  "--vq_ckpt", vae_ckpt, "--sampler", "dpmpp",
                  "--sample_steps", "2"),
                 ("--model", "vae", "--name", "vae"),
                 ("--model", "union", "--stage", "lr", "--name", "lr",
                  "--sample_steps", "2")):
        written = _cli(root, "--mode", "generate", "--count", "1", *argv)
        assert len(written) == 1
        if written[0].endswith(".obj"):
            assert _obj_faces(written[0]) > 0
        else:
            split = np.load(written[0])["split_small"]
            assert split.shape == (4, 4, 4, 8)
            assert np.isfinite(split).all() and (split != 0).all()
    assert "loaded EMA diffusion weights" in capsys.readouterr().out


def test_cli_trains_a_conditional_model(tmp_path):
    """With ``diffusion.num_classes`` the batches' labels (int64 on the
    device) reach both U-Nets' class embeddings, and generate takes
    ``--category``'s label."""
    root = str(tmp_path)
    cfg = tiny_cfg()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, class_families=True),
        diffusion=dataclasses.replace(cfg.diffusion, num_classes=5))
    config_lib.dump_config(cfg, os.path.join(root, "cfg.yaml"))
    for stage in ("lr", "hr"):
        stats = _cli(root, "--model", "union", "--stage", stage, "--name",
                     stage, "--max_steps", "1")
        assert np.isfinite(stats["loss"]).all()
    hr = ckpt_lib.restore(os.path.join(root, "hr", "ckpt", "steps-latest"))
    assert hr["df_unet_hr"]["label_emb.weight"].shape[0] == 5
    written = _cli(root, "--model", "union", "--stage", "hr", "--name", "hr",
                   "--mode", "generate", "--count", "1", "--category", "car",
                   "--sampler", "dpmpp", "--sample_steps", "2")
    assert len(written) == 1


def tiny_3t_cfg():
    """The tiny config as a 3-stage model (``tests/test_union_3t.py``'s
    sizes: depth 5, depth_stop 4 = ``input_depth[2]``)."""
    cfg = tiny_cfg()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, depth=5, depth_stop=4,
                                  depth_out=5, channels=(4, 8, 8, 8, 8, 8)),
        capacity=dataclasses.replace(cfg.capacity, finest_cap=4096),
        diffusion=dataclasses.replace(
            cfg.diffusion, ddim_steps=4, unet_type=("lr", "hr", "feature"),
            df_type=("x0", "x0", "x0"), input_depth=(2, 3, 4),
            input_channels=(8, 8, 2), out_channels=(8, 8, 2),
            model_channels=(8, 16, 16),
            num_res_blocks=((1, 1), (1, 0), (1, 0)),
            channel_mult=((1, 2), (1, 1), (1, 1))),
        train=dataclasses.replace(cfg.train, print_freq=1,
                                  save_latest_freq=1, display_freq=2))


def test_cli_trains_union_3t_and_generates(tmp_path, capsys):
    """``--model union_3t``: lr, then hr grafted from it, then feature
    grafted from the hr run with ``--vq_ckpt``, then generate: the feature
    run's checkpoint holds ``df_unet_feature`` and an EMA that differs from
    it after a step, and the frozen U-Nets of the runs before it."""
    root = str(tmp_path)
    config_lib.dump_config(tiny_3t_cfg(), os.path.join(root, "cfg.yaml"))
    ck = lambda name: os.path.join(root, name, "ckpt", "steps-latest")
    _cli(root, "--model", "vae", "--name", "vae", "--max_steps", "1")
    _cli(root, "--model", "union_3t", "--stage", "lr", "--name", "lr",
         "--max_steps", "1")
    _cli(root, "--model", "union_3t", "--stage", "hr", "--name", "hr",
         "--max_steps", "1", "--pretrain_ckpt", ck("lr"))
    stats = _cli(root, "--model", "union_3t", "--stage", "feature", "--name",
                 "feat", "--max_steps", "2", "--vq_ckpt", ck("vae"),
                 "--pretrain_ckpt", ck("hr"))
    assert np.isfinite(stats["loss"]).all()
    out = capsys.readouterr().out
    for line in ("[*] grafted unet_lr from", "[*] grafted unet_hr from",
                 "[*] loaded VAE weights from",
                 "[*] trained union_3t feature on cpu: steps=2 "):
        assert line in out, line
    assert "display eval failed" not in out
    trees = {n: ckpt_lib.restore(ck(n)) for n in ("lr", "hr", "feat")}
    assert sorted(trees["hr"]) == ["df_unet_hr", "df_unet_lr",
                                   "ema_df_unet_hr", "ema_df_unet_lr",
                                   "train_state"]
    feat = trees["feat"]
    assert sorted(feat) == sorted(
        [f"{p}df_unet_{k}" for p in ("", "ema_") for k in ("lr", "hr",
                                                            "feature")]
        + ["train_state"])
    assert any(not torch.equal(v, feat["ema_df_unet_feature"][k])
               for k, v in feat["df_unet_feature"].items())
    for kind, src in (("lr", "lr"), ("hr", "hr")):
        for k, v in trees[src][f"df_unet_{kind}"].items():
            assert torch.equal(feat[f"df_unet_{kind}"][k], v), (kind, k)

    written = _cli(root, "--model", "union_3t", "--stage", "feature",
                   "--name", "feat", "--mode", "generate", "--count", "1",
                   "--vq_ckpt", ck("vae"), "--sampler", "dpmpp",
                   "--sample_steps", "2")
    assert len(written) == 1 and _obj_faces(written[0]) > 0
    assert "loaded EMA diffusion weights" in capsys.readouterr().out
    written = _cli(root, "--model", "union_3t", "--stage", "hr", "--name",
                   "hr", "--mode", "generate", "--count", "1",
                   "--sample_steps", "2")
    arrays = np.load(written[0])
    assert arrays["split_small"].shape == (4, 4, 4, 8)
    assert arrays["split_large"].shape[1] == 8
    assert np.isfinite(arrays["split_large"]).all()


def test_feature_graft_brings_unet_hr_and_its_ema(batches):
    """A feature run grafts an hr run's ``unet_lr`` and ``unet_hr``,
    weights and EMA (the JAX package's ``train.py:219-233``); its own
    ``unet_feature`` keeps its weights."""
    cfg = tiny_3t_cfg()
    torch.manual_seed(3)
    hr_step = Union3TSolver(cfg, "hr", device="cpu").make_train_step()
    gen = torch.Generator().manual_seed(1)
    ttrain.train_loop(hr_step, iter(batches), 1, generator=gen)
    tree = ttrain.training_checkpoint(hr_step)
    torch.manual_seed(4)
    step = Union3TSolver(cfg, "feature", device="cpu").make_train_step()
    own = {k: v.clone() for k, v in
           step.solver.df.unet_feature.state_dict().items()}
    assert params_lib.graft_union_checkpoint(
        step.solver.df, step.ema, tree, ttrain.GRAFTS["feature"]) == [
            "lr", "hr"]
    for kind in ("lr", "hr"):
        net = getattr(step.solver.df, f"unet_{kind}")
        for k, v in net.state_dict().items():
            assert torch.equal(v, tree[f"df_unet_{kind}"][k]), (kind, k)
            assert torch.equal(step.ema[f"unet_{kind}.{k}"],
                               tree[f"ema_df_unet_{kind}"][k]), (kind, k)
    assert any(not torch.equal(tree["df_unet_hr"][k],
                               tree["ema_df_unet_hr"][k])
               for k in tree["df_unet_hr"])
    for k, v in step.solver.df.unet_feature.state_dict().items():
        assert torch.equal(v, own[k]), k


def test_cli_refuses_a_feature_stage_of_the_two_stage_model(tmp_path):
    with pytest.raises(SystemExit, match="union_3t"):
        ttrain.main(["--model", "union", "--stage", "feature", "--config",
                     TINY_YAML, "--logs_dir", str(tmp_path), "--device",
                     "cpu"])


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ttrain.main(["--config", TINY_YAML, "--logs_dir", str(tmp_path)])


def test_vq_ckpt_rejects_a_directory(tmp_path):
    solver = VAESolver(tiny_cfg(), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        params_lib.load_vae_checkpoint(solver.vae, str(tmp_path))


# ----------------------------------------------------------------------
# overflow monitor and stall watchdog
# ----------------------------------------------------------------------
def test_monitor_raises_for_nonprint_step_overflow():
    mon = OverflowMonitor()
    print_freq = 5
    for it in range(5):       # overflow only at step 2, not a print step
        mon.update({"overflow": torch.tensor(1.0 if it == 2 else 0.0)})
        if it % print_freq == 0:
            mon.check()
    with pytest.raises(RuntimeError, match="capacity overflow"):
        mon.check()


def test_monitor_quiet_without_overflow():
    mon = OverflowMonitor()
    for _ in range(7):
        mon.update({"overflow": torch.tensor(0.0)})
    mon.check()
    mon.update({})            # a step without the key (lr from split_small)
    mon.check()


def test_train_loop_raises_on_overflow(batches):
    """A step that reports an overflow stops the loop at its end, even
    without print steps."""
    class Overflowing:
        step = 0

        def __call__(self, batch, generator=None):
            return {"loss": torch.tensor(1.0), "overflow": torch.tensor(1.0)}

    with pytest.raises(RuntimeError, match="capacity overflow"):
        ttrain.train_loop(Overflowing(), iter(batches), 3)


def test_watchdog_fires_on_stall():
    fired = threading.Event()
    dog = StallWatchdog(timeout_s=0.3, on_stall=fired.set, poll_s=0.05)
    assert fired.wait(3.0), "watchdog never fired on a stalled run"
    dog.stop()


def test_watchdog_poke_defers():
    fired = threading.Event()
    dog = StallWatchdog(timeout_s=0.5, on_stall=fired.set, poll_s=0.05)
    for _ in range(6):
        time.sleep(0.15)
        dog.poke()
    assert not fired.is_set(), "watchdog fired despite steady progress"
    dog.stop()
    time.sleep(0.3)
    assert not fired.is_set(), "watchdog fired after stop()"


def test_watchdog_disabled(monkeypatch):
    monkeypatch.setenv("OCTFUSION_STALL_TIMEOUT", "0")
    fired = threading.Event()
    dog = StallWatchdog(on_stall=fired.set, poll_s=0.05)
    time.sleep(0.3)
    assert not fired.is_set()
    assert dog.timeout_s == 0 and dog._thread is None
    dog.stop()


def test_loader_bench_runs_on_the_cpu():
    """``tools/loader_bench`` at the tiny size: every timing present,
    finite and positive, the A/B's three runs in order."""
    from octfusion_tpu_torch.tools import loader_bench

    res = loader_bench.main([
        "--config", os.path.join(REPO, "configs", "synthetic_tiny.yaml"),
        "--device", "cpu"])
    assert [r["source"] for r in res["ab"]] == ["preloaded", "loader",
                                                "preloaded"]
    nums = [*res["samples"].values(), *res["loader"].values(),
            *(r[k] for r in res["ab"] for k in ("ms_per_step",
                                                 "cpu_s_per_step"))]
    assert all(np.isfinite(v) and v > 0 for v in nums), res
    assert all(r["data_s"] >= 0 for r in res["ab"])
