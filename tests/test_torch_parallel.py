"""vqatpu_torch.parallel against vqatpu.parallel, on the CPU.

- ``param_shardings`` gives JAX's ``NamedSharding`` specs leaf for leaf
  (tests/test_sharding.py's layouts: tp=2 and tp=4, 16 and 3129 answers),
  with no process group: JAX runs on its 8 virtual CPU devices.
- Several processes on CPU gloo: a module-level worker, started by
  ``torch.multiprocessing`` (spawn) on a free port, runs one scenario and
  writes its numbers; each test has its own timeout and joins its workers.
  The same global batch and weights go through JAX's single-device step
  (``deterministic=True``: dropout streams never align), and the port's
  DDP at 2 ranks, tp=2 and dp=2 x tp=2 steps are held to it at 1e-5; the
  tp=2 forward to JAX's unsplit logits; CTI's blockwise path at tp=2 to
  JAX's one-device blockwise forward and step at 1e-5; SAN and TanModel
  at tp=2 to JAX's steps (params at the trajectory tolerance); the
  row-sharded store to the replicated one, bit for bit; rank 0's
  checkpoint of a tp=2 ``train()`` run, read by
  ``vqatpu.train.checkpoints``, to the single-process run's.
"""

import os
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CFG = dict(ntoken=50, v_dim=16, num_ans_candidates=16, model="cti",
           num_hid=16, h_mm=8, rank=4, gamma=2)
B, BOXES, REAL = 8, 6, 5
PARAM_SEED, BATCH_SEED, LR = 3, 11, 1e-3
TOL = 1e-5
TRAJ_TOL = 1e-4  # params after a step of SAN and TanModel (Adamax, see below)
TIMEOUT = 120  # seconds for a group of workers
N_TRAIN, N_VAL, MAX_BOXES = 16, 8, 12
# the model each scenario trains: CTI; CTI's blockwise path (2 blocks of 4
# boxes over BOXES); SAN; the multiple-choice TanModel (B rows = B / 4
# questions, scored per question)
VARIANTS = {"cti": CFG, "blockwise": dict(CFG, v_block_size=4),
            "san": dict(CFG, model="san"),
            "tan": dict(CFG, task="mc", model="tan")}


# -- the workers -----------------------------------------------------------

def _batch(variant="cti"):
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.data.mc_dataset import expand_mc_batch
    from vqatpu_torch.weights import numpy_batch

    cfg = ModelConfig(**VARIANTS[variant])
    if cfg.task == "mc":
        rows = expand_mc_batch(numpy_batch(cfg, B // 4, seed=BATCH_SEED,
                                           boxes=BOXES, real_boxes=REAL))
        return {k: rows[k] for k in ("v", "b", "q", "a", "target")}
    return numpy_batch(cfg, B, seed=BATCH_SEED, boxes=BOXES,
                       real_boxes=REAL, target=True)


def _state(variant="cti"):
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train import make_train_state
    from vqatpu_torch.weights import load_jax_params, numpy_params

    cfg = ModelConfig(**VARIANTS[variant])
    model = load_jax_params(build_model(cfg), numpy_params(cfg, PARAM_SEED))
    return make_train_state(model, device="cpu")


def _step_on(mesh, variant="cti", save_to=None) -> dict:
    """One deterministic step of this rank's share; -> its metrics, the
    logits of the forward before it and the whole params after it.  With
    ``save_to`` every rank takes part in both savers' gathers and rank 0
    writes ``m.ckpt`` and ``m.orbax`` there."""
    from vqatpu_torch.config import TrainConfig
    from vqatpu_torch.parallel import shard_batch
    from vqatpu_torch.train import make_train_step
    from vqatpu_torch.train.loop import put_on_mesh
    from vqatpu_torch.weights import gather_state

    cfg = TrainConfig(update_freq=1, deterministic=True)
    state = _state(variant)
    specs = put_on_mesh(state, mesh, cfg)
    batch = _batch(variant)
    with torch.no_grad():
        logits, _ = state.model(*(torch.from_numpy(batch[k])
                                  for k in ("v", "q", "a")))
    local = shard_batch(batch, mesh)
    step = make_train_step(state.model, cfg, mesh=mesh,
                           mc_scoring=VARIANTS[variant].get("task") == "mc")
    m = step(state, local, LR, torch.Generator().manual_seed(0))
    if save_to is not None:
        from vqatpu_torch.train.checkpoints import (save_checkpoint,
                                                    save_checkpoint_orbax)

        save_checkpoint(os.path.join(save_to, "m.ckpt"), state, 0,
                        mesh=mesh, write=mesh.primary)
        save_checkpoint_orbax(os.path.join(save_to, "m.orbax"), state, 0,
                              mesh=mesh, write=mesh.primary)
    params = gather_state({n: p.detach() for n, p in
                           state.model.named_parameters()}, mesh, specs)
    out = {"p." + k: v.numpy() for k, v in params.items()}
    out.update({k: m[k].numpy() for k in ("loss", "grad_norm",
                                          "batch_score")})
    out["logits"] = logits.numpy()
    out["split"] = np.array(sorted(k for k, d in specs.items()
                                   if d is not None))
    return out


def _scenario_ddp(root):
    from vqatpu_torch.parallel import make_mesh
    return _step_on(make_mesh())


def _scenario_tp(root):
    from vqatpu_torch.parallel import make_mesh_2d
    return _step_on(make_mesh_2d(1, 2), save_to=root)


def _scenario_dp_tp(root):
    from vqatpu_torch.parallel import make_mesh_2d
    return _step_on(make_mesh_2d(2, 2))


def _tp_scenario(variant):
    def scenario(root):
        from vqatpu_torch.config import ModelConfig
        from vqatpu_torch.models import build_model
        from vqatpu_torch.train.loop import _make_mesh

        # train()'s mesh choice, which refuses what neither package runs
        model = build_model(ModelConfig(**VARIANTS[variant]))
        return _step_on(_make_mesh(model, True, None, 2), variant)
    return scenario


def _dataset(root, split="train"):
    from vqatpu_torch.data.datasets import VQAFeatureDataset
    from vqatpu_torch.data.dictionary import Dictionary

    d = Dictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
    return VQAFeatureDataset(split, d, dataroot=root, max_boxes=MAX_BOXES)


def _scenario_store(root):
    """Sharded gathers of 2-rank slices against the replicated store's,
    for every wire; -> the number of batches held equal."""
    from vqatpu_torch.data.device_store import DeviceFeatureStore
    from vqatpu_torch.parallel import make_mesh, shard_batch
    from vqatpu_torch.train.steps import upcast_wire

    mesh = make_mesh()
    ds = _dataset(root)
    rs = np.random.RandomState(5)
    n = 0
    for wire in ("float32", "float16", "int8"):
        rep = DeviceFeatureStore.build(ds, transfer_dtype=wire, device="cpu")
        sh = DeviceFeatureStore.build(ds, transfer_dtype=wire, device="cpu",
                                      shard=True, mesh=mesh)
        assert sh.feats.shape[0] == -(-rep.feats.shape[0] // 2)
        for _ in range(4):
            idx = rs.randint(-1, len(ds), size=8)  # -1: a padded row
            local = shard_batch({"ds_idx": idx}, mesh)["ds_idx"]
            want = upcast_wire(rep.gather(local))
            got = sh.gather(local)
            assert set(got) == {"v", "b", "v_mask"}
            for k in ("v", "b", "v_mask"):
                assert got[k].dtype == want[k].dtype, (wire, k)
                assert torch.equal(got[k], want[k]), (wire, k)
                if k != "v_mask":  # bit for bit, the sign of zero included
                    assert torch.equal(got[k].view(torch.int32),
                                       want[k].view(torch.int32)), (wire, k)
            n += 1
    return {"batches": np.array(n)}


def _scenario_tp_loop(root):
    from vqatpu_torch.cli.ffoe_train import main
    main(_loop_argv(root, os.path.join(root, "tp_run"), "--tp", "2"))
    return {}


def _loop_argv(root, out, *extra):
    return ["--model", "cti", "--dataroot", root, "--output", out,
            "--num_hid", "16", "--h_mm", "8", "--rank", "4",
            "--batch_size", "8", "--max_boxes", str(MAX_BOXES),
            "--epochs", "10", "--print_interval", "1000", "--device", "cpu",
            "--device_features", "off", "--no_native_loader", *extra]


SCENARIOS = {"ddp": _scenario_ddp, "tp": _scenario_tp,
             "dp_tp": _scenario_dp_tp, "store": _scenario_store,
             "tp_loop": _scenario_tp_loop,
             **{f"tp_{v}": _tp_scenario(v)
                for v in ("blockwise", "san", "tan")}}


def _worker(rank, world, port, scenario, root, out_dir):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        out = SCENARIOS[scenario](root)
        np.savez(os.path.join(out_dir, f"{scenario}_{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(out_dir, f"{scenario}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(scenario, world, root, out_dir):
    """Start ``world`` workers, join them within TIMEOUT; -> each rank's
    numbers."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, scenario,
                                                str(root), str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(out_dir / f"{scenario}_{r}.err").read()
              for r in range(world) if (out_dir / f"{scenario}_{r}.err").exists()]
    assert not hung, f"{scenario}: ranks {hung} did not end in {TIMEOUT} s"
    assert not errors, errors[0]
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [dict(np.load(out_dir / f"{scenario}_{r}.npz"))
            for r in range(world)]


# -- the JAX side ----------------------------------------------------------

def jax_step(variant="cti"):
    """JAX's single-device deterministic step on the global batch: the
    logits before it, its metrics and the params after it (flat keys)."""
    import jax
    import jax.numpy as jnp

    from vqatpu.config import ModelConfig as JaxModelConfig
    from vqatpu.config import TrainConfig as JaxTrainConfig
    from vqatpu.models import build_model as jax_build_model
    from vqatpu.train import steps as jsteps
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.weights import (jax_params_from_torch, numpy_params,
                                      torch_state_from_jax)

    kw = VARIANTS[variant]
    params = numpy_params(ModelConfig(**kw), PARAM_SEED)
    model = jax_build_model(JaxModelConfig(**kw))
    batch = {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
             for k, x in _batch(variant).items()}
    logits, _ = model.apply(jax.tree.map(jnp.asarray, params), batch)
    state = jsteps.make_train_state(model, jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = jsteps.make_train_step(
        model, JaxTrainConfig(update_freq=1, deterministic=True),
        mc_scoring=kw.get("task") == "mc")
    state, m = step(state, batch, jnp.float32(LR), jax.random.PRNGKey(1))
    flat = torch_state_from_jax(jax.tree.map(np.asarray, state.params))
    assert jax_params_from_torch(flat)  # the port's key mapping
    out = {"p." + k: v.numpy() for k, v in flat.items()}
    out.update({k: np.asarray(m[k]) for k in ("loss", "grad_norm",
                                              "batch_score")})
    out["logits"] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def want():
    return jax_step()


def assert_step_matches(got, want, param_tol=TOL):
    for k in ("loss", "grad_norm", "batch_score"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    keys = sorted(k for k in want if k.startswith("p."))
    assert sorted(k for k in got if k.startswith("p.")) == keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=param_tol,
                                   atol=param_tol, err_msg=k)


# -- shardings -------------------------------------------------------------

def _spec_dim(spec):
    dims = [i for i, name in enumerate(spec) if name is not None]
    return dims[0] if dims else None


@pytest.mark.parametrize("tp,n_ans", [(2, 16), (2, 3129), (4, 16),
                                      (4, 3129)])
def test_param_shardings_match_jax(tp, n_ans):
    import jax

    from vqatpu.config import ModelConfig as JaxModelConfig
    from vqatpu.models import build_model as jax_build_model
    from vqatpu.parallel import make_mesh_2d
    from vqatpu.parallel import param_shardings as jax_shardings
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.parallel import Mesh, param_shardings
    from vqatpu_torch.weights import torch_state_from_jax

    kw = dict(ntoken=50, v_dim=32, num_ans_candidates=n_ans, model="cti",
              num_hid=32, h_mm=16, rank=4, gamma=2)  # tests/test_models.py
    jparams = jax_build_model(JaxModelConfig(**kw)).init(jax.random.PRNGKey(0))
    jsh = jax_shardings(jparams, make_mesh_2d(8 // tp, tp))
    flat = torch_state_from_jax(jax.tree.map(
        lambda s: np.zeros(()), jsh, is_leaf=lambda x: hasattr(x, "spec")))
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            jsh, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        key = ".".join(p.key for p in path)
        want[key] = _spec_dim(s.spec)
    want = dict(zip(flat, want.values()))
    got = param_shardings(build_model(ModelConfig(**kw)), Mesh(8 // tp, tp))
    assert got == want
    assert (got["classifier.l2.v"] is None) == (n_ans % tp != 0)
    assert got["t_att.tc.T_g"] == 0 and got["q_prj0.l0.v"] == 1


def test_ban_has_no_tp_layout_in_either_package():
    """JAX's rules name the model axis on BAN's scalar weight-norm g, where
    its fits() raises; the port refuses the layout."""
    import jax

    from vqatpu.config import ModelConfig as JaxModelConfig
    from vqatpu.models import build_model as jax_build_model
    from vqatpu.parallel import make_mesh_2d
    from vqatpu.parallel import param_shardings as jax_shardings
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.parallel import Mesh, param_shardings

    kw = dict(CFG, model="ban")
    with pytest.raises(IndexError):
        jax_shardings(jax_build_model(JaxModelConfig(**kw)).init(
            jax.random.PRNGKey(0)), make_mesh_2d(4, 2))
    with pytest.raises(ValueError, match="no tensor-parallel layout"):
        param_shardings(build_model(ModelConfig(**kw)), Mesh(4, 2))
    assert set(param_shardings(build_model(ModelConfig(**kw)),
                               Mesh(8, 1)).values()) == {None}


# -- several processes -----------------------------------------------------

def test_ddp_two_ranks_matches_jax_single_device(tmp_path, want):
    outs = run_group("ddp", 2, tmp_path, tmp_path)
    for got in outs:
        assert_step_matches(got, want)
    assert len(outs[0]["split"]) == 0


def test_tp2_forward_and_step_match_jax(tmp_path, want):
    """Also both savers under tp: rank 0's ``.ckpt`` and ``.orbax`` of the
    gathered state restore in JAX to the same params and Adamax state, the
    whole params of the step."""
    import jax

    from vqatpu.config import ModelConfig as JaxModelConfig
    from vqatpu.models import build_model as jax_build_model
    from vqatpu.train import checkpoints as jckpt
    from vqatpu.train import steps as jsteps

    outs = run_group("tp", 2, tmp_path, tmp_path)
    for got in outs:
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL,
                                   atol=TOL)
        assert_step_matches(got, want)
    split = set(outs[0]["split"])
    assert {"classifier.l2.v", "t_att.tc.T_g", "t_net0.v_tucker.l0.v",
            "q_prj1.l0.v"} <= split
    jm = jax_build_model(JaxModelConfig(**CFG))
    fresh = jsteps.make_train_state(jm, jax.random.PRNGKey(0))
    orbax, _ = jckpt.restore_train_state_orbax(str(tmp_path / "m.orbax"),
                                               fresh)
    ckpt, _, _ = jckpt.restore_train_state(str(tmp_path / "m.ckpt"), fresh)
    for a, b in zip(jax.tree.leaves((orbax.params, orbax.opt_state)),
                    jax.tree.leaves((ckpt.params, ckpt.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    flat = jax.tree_util.tree_flatten_with_path(orbax.params)[0]
    assert len(flat) == len([k for k in outs[0] if k.startswith("p.")])


def test_dp2_tp2_step_matches_jax(tmp_path, want):
    for got in run_group("dp_tp", 4, tmp_path, tmp_path):
        assert_step_matches(got, want)


def test_tp2_blockwise_forward_and_step_match_jax(tmp_path):
    """CTI's blockwise path (2 V blocks) at tp=2: the rank-split operands
    are gathered whole before the softmax statistics and each rank pools
    its ``d / 2`` columns; the logits and the step equal JAX's one-device
    blockwise ones."""
    want = jax_step("blockwise")
    outs = run_group("tp_blockwise", 2, tmp_path, tmp_path)
    for got in outs:
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=TOL,
                                   atol=TOL)
        assert_step_matches(got, want)
    assert {"t_att.tc.T_g", "t_net0.v_tucker.l0.v"} <= set(outs[0]["split"])


def test_fused_v_tucker_stays_refused_under_tp():
    """JAX refuses fused_v_tucker on a model axis
    (``vqatpu/train/loop.py:259-263``) and so does the port; the blockwise
    path is no longer refused."""
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train.loop import _make_mesh

    fused = build_model(ModelConfig(**dict(CFG, fused_v_tucker=True)))
    with pytest.raises(ValueError, match="fused_v_tucker is incompatible"):
        _make_mesh(fused, True, None, 2)
    blockwise = build_model(ModelConfig(**VARIANTS["blockwise"]))
    with pytest.raises(ValueError, match="one process a device"):
        _make_mesh(blockwise, True, None, 2)  # one process here: no mesh


@pytest.mark.parametrize("variant,split", [
    ("san", {"classifier.l2.v"}),
    ("tan", {"v_att.tc.T_g", "t_net0.v_tucker.l0.v", "q_prj1.l0.v"})])
def test_tp2_san_and_tan_steps_match_jax(tmp_path, variant, split):
    """SAN (only its classifier split) and the multiple-choice TanModel at
    tp=2: loss and pre-clip grad norm within 1e-5 of JAX's one-device step,
    params within the trajectory tolerance (1e-4): the port in one process
    is already about 1e-5 off JAX on these params after a step, through
    Adamax's ``g / (|g| + eps)`` on near-zero gradients."""
    want = jax_step(variant)
    outs = run_group(f"tp_{variant}", 2, tmp_path, tmp_path)
    for got in outs:
        assert_step_matches(got, want, param_tol=TRAJ_TOL)
    assert split <= set(outs[0]["split"])


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    from vqatpu_torch.data.synthetic import make_vqa_fixture

    root = tmp_path_factory.mktemp("data_vqa")
    make_vqa_fixture(str(root), n_train=N_TRAIN, n_val=N_VAL, n_images=8,
                     v_dim=16)
    return root


def test_sharded_store_equals_replicated_at_two_ranks(dataroot, tmp_path):
    outs = run_group("store", 2, dataroot, tmp_path)
    assert [int(o["batches"]) for o in outs] == [12, 12]


def test_tp_checkpoint_reads_in_jax_and_equals_one_process(dataroot,
                                                           tmp_path):
    """``ffoe_train --tp 2`` over 2 gloo processes (dropout on: with one data
    index the masks are the single process's) against the same run in one
    process: rank 0's epoch-9 checkpoint, read by vqatpu, equals the
    single-process one's params and Adamax state."""
    import jax

    from vqatpu.config import ModelConfig as JaxModelConfig
    from vqatpu.models import build_model as jax_build_model
    from vqatpu.train import checkpoints as jckpt
    from vqatpu.train import steps as jsteps
    from vqatpu_torch.cli.ffoe_train import main

    root = str(dataroot)
    main(_loop_argv(root, os.path.join(root, "one_run"), "--no_mesh"))
    run_group("tp_loop", 2, dataroot, tmp_path)
    ds = _dataset(root)
    model = jax_build_model(JaxModelConfig(
        ntoken=ds.dictionary.ntoken, v_dim=ds.v_dim,
        num_ans_candidates=ds.num_ans_candidates, model="cti", num_hid=16,
        h_mm=8, rank=4, gamma=2))
    states = []
    for run in ("one_run", "tp_run"):
        files = sorted(os.listdir(os.path.join(root, run)))
        assert "model_epoch9.ckpt" in files, files
        template = jsteps.make_train_state(model, jax.random.PRNGKey(0),
                                           tfidf_loaded=True)
        state, start, _ = jckpt.restore_train_state(
            os.path.join(root, run, "model_epoch9.ckpt"), template)
        assert start == 10
        states.append(state)
    one, tp = states
    for a, b in zip(jax.tree.leaves(tp.params), jax.tree.leaves(one.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    for a, b in zip(jax.tree.leaves(tp.opt_state),
                    jax.tree.leaves(one.opt_state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    log = open(os.path.join(root, "tp_run", "log.txt")).read()
    assert "mesh: data=1 x model=2" in log
