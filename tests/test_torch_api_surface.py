"""The port's public surface against the JAX package's.

An AST walk lists the public methods and properties of the reference's
``DeepSpeedTPUEngine``, ``DeepSpeedTPUConfig`` and ``ParamOffloadTrainer``
and the names ``deepspeed_tpu/__init__.py`` defines or re-exports. Each
must exist in the port. Each is then used on the same tiny fp32 Llama
config on both sides (one JAX device; the port on the CPU): it answers as
the JAX package does (accessors, ``train``/``eval``, ``compile``,
``get_params`` against the JAX engine's params, the config accessors, the
offload trainer's master tree and ``load_masters``, the micro-step
protocol step for step, the async pipeline's calls with the pipeline off,
``initialize``'s loader of ``training_data``, ``save_checkpoint`` and
``load_checkpoint`` each on its own package's checkpoint), or it raises
``NotImplementedError`` naming its ROADMAP Queue 1 item (the resilience
runner's names and chaos's training knobs: item 6b).
"""

import argparse
import ast
import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.comm.mesh import create_mesh  # noqa: E402
from deepspeed_tpu.config.config import (DeepSpeedTPUConfig as JConfig,  # noqa: E402
                                         MeshConfig)
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine  # noqa: E402
from deepspeed_tpu_torch.runtime.param_offload import ParamOffloadTrainer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _public(path, cls):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return [b.name for b in node.body
                    if isinstance(b, ast.FunctionDef)
                    and (not b.name.startswith("_") or b.name == "__call__")]
    raise AssertionError(f"{cls} not in {path}")


def _package_names():
    tree = ast.parse((ROOT / "deepspeed_tpu/__init__.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            names.append(node.name)
        elif isinstance(node, ast.ImportFrom) and node.module not in (
                "typing", "deepspeed_tpu.utils", "deepspeed_tpu.comm"):
            names += [a.asname or a.name for a in node.names
                      if not (a.asname or a.name).startswith("_")]
    return names


ENGINE = _public("deepspeed_tpu/runtime/engine.py", "DeepSpeedTPUEngine")
CONFIG = _public("deepspeed_tpu/config/config.py", "DeepSpeedTPUConfig")
OFFLOAD = _public("deepspeed_tpu/runtime/param_offload.py", "ParamOffloadTrainer")
PACKAGE = _package_names()


def test_every_public_name_exists_in_the_port():
    assert len(ENGINE) >= 30 and len(CONFIG) >= 7 and len(OFFLOAD) >= 5
    assert {"initialize", "init_inference", "add_config_arguments",
            "DeepSpeedTPUConfig", "DeepSpeedTPUEngine", "log_dist",
            "logger", "get_accelerator"} <= set(PACKAGE)
    missing = [n for n in ENGINE if not hasattr(DeepSpeedTPUEngine, n)]
    missing += [n for n in CONFIG if not hasattr(DeepSpeedTPUConfig, n)]
    missing += [n for n in OFFLOAD if not hasattr(ParamOffloadTrainer, n)]
    missing += [n for n in PACKAGE if not hasattr(deepspeed_tpu_torch, n)]
    assert not missing, missing


def _waits(fn, *a, **kw):
    """True when ``fn`` raises NotImplementedError naming its item."""
    with pytest.raises(NotImplementedError) as e:
        fn(*a, **kw)
    assert "ROADMAP Queue 1 item" in str(e.value), str(e.value)
    return True


CONFIG_RAW = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "fp16": {"enabled": True, "loss_scale": 128.0},
              "zero_optimization": {"stage": 2}}


@pytest.mark.parametrize("name", CONFIG)
def test_config_surface_answers_as_jax(name):
    ours, ref = DeepSpeedTPUConfig(dict(CONFIG_RAW)), JConfig(dict(CONFIG_RAW))
    if name == "resolve_batch_sizes":
        for c in (ours, ref):
            c.resolve_batch_sizes(2)
        assert (ours.train_batch_size, ours.train_micro_batch_size_per_gpu,
                ours.gradient_accumulation_steps) == \
            (ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
             ref.gradient_accumulation_steps)
        return
    got, want = getattr(ours, name), getattr(ref, name)
    if name == "raw":
        got, want = got(), want()
    if name in ("precision_dtype", "grad_accum_dtype"):
        got, want = str(got).split(".")[-1], jnp.dtype(want).name
        want = {"float16": "float16", "float32": "float32",
                "bfloat16": "bfloat16"}[want]
    assert got == want, name


def _configs():
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla")
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    params = jax.tree.map(np.asarray, jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, 512))["params"])
    return jcfg, tcfg, params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def engines():
    return _engine_pair()


def _engine_pair():
    jcfg, tcfg, params = _configs()
    # the fp32 trajectory recipe of tests/test_torch_train.py, whose
    # masters agree within 1e-5 after a step
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "gradient_clipping": 1.0,
              "scheduler": {"type": "WarmupLR",
                            "params": {"warmup_min_lr": 0.0,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 3}}}
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(jcfg), config=dict(config),
        model_parameters=params, mesh=mesh)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaForCausalLM(tcfg, device="cpu"),
        config=dict(config), model_parameters=params, device="cpu")
    return jeng, teng


BATCH = jllama.random_tokens(4, 16, vocab_size=512, seed=5)
STACKED = jllama.random_tokens(4, 16, vocab_size=512, seed=6, gas=2)
# how each engine call is made (args), and how its answers compare
ENGINE_CALLS = {
    "stack_microbatches": ((iter([BATCH, BATCH]), 2), "stacked"),
    "train_batch": ((), "loss"),
    "set_nonfinite_guard": ((False,), "none"),
    "eval_batch": ((BATCH,), "loss"),
    "get_lr": ((), "lr"),
    "get_global_grad_norm": ((), "close"),
    "cur_scale": ((), "equal"),
    "skipped_steps": (None, "equal"),
    "zero_optimization_stage": ((), "equal"),
    "train_micro_batch_size_per_gpu": ((), "equal"),
    "is_gradient_accumulation_boundary": ((), "equal"),
    "train": ((False,), "self"),
    "eval": ((), "self"),
    "compile": ((), "self"),
    "get_params": ((), "tree"),
    "module_state_dict": ((), "tree"),
    # the micro-step protocol: a whole step of the DeepSpeed loop
    "forward": ((), "micro"),
    "__call__": ((), "micro"),
    "backward": ((), "micro"),
    "step": ((), "micro"),
    # checkpoints: each package saves and restores its own
    "save_checkpoint": ((), "ckpt"),
    "load_checkpoint": ((), "ckpt"),
    # the async pipeline, off: nothing pending, nothing drained
    "flush_metrics": ((), "equal"),
    "take_drained_metrics": ((), "equal"),
    "requeue_drained_metrics": (([],), "equal"),
    "configure_async_pipeline": ((), "self"),
}


@pytest.mark.parametrize("name", ENGINE)
def test_engine_surface_answers_as_jax_or_names_its_item(engines, name,
                                                        tmp_path):
    jeng, teng = engines
    if name not in ENGINE_CALLS:
        fn = getattr(teng, name)
        args = {"dump_trace": (), "trace_summary": (), "memory_ledger": (),
                "memory_forensics": (), "dump_memory_report": (),
                "start_profile_trace": ("/nonexistent",),
                "stop_profile_trace": (),
                "set_custom_curriculum_learning_schedule": (lambda s: s,),
                "curriculum_seqlen": (), "random_ltd_reserved_length": ()
                }[name]
        assert _waits(fn, *args)
        return
    args, how = ENGINE_CALLS[name]
    if name == "train_batch":
        got = float(teng.train_batch(batch=STACKED, stacked=True))
        want = float(jeng.train_batch(batch=STACKED, stacked=True))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        return
    if how == "ckpt":
        # a step on a fresh pair, a save with client state on each side
        # (the same tag), then each loaded into a fresh engine: the same
        # path tail, client state and step, the trained masters
        jeng, teng = _engine_pair()
        for eng in (teng, jeng):
            eng.train_batch(batch=STACKED, stacked=True)
        got = teng.save_checkpoint(str(tmp_path / "port"),
                                   client_state={"epoch": 3})
        want = jeng.save_checkpoint(str(tmp_path / "jax"),
                                    client_state={"epoch": 3})
        assert Path(got).name == Path(want).name == "global_step1"
        if name == "load_checkpoint":
            j2, t2 = _engine_pair()
            (gp, gc) = t2.load_checkpoint(str(tmp_path / "port"))
            (wp, wc) = j2.load_checkpoint(str(tmp_path / "jax"))
            assert Path(gp).name == Path(wp).name and gc == wc == {"epoch": 3}
            assert t2.global_steps == j2.global_steps == 1
            want = _flat(jax.tree.map(np.asarray, jeng.get_params()))
            got = _flat(t2.get_params())
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=1e-5,
                                           err_msg=k)
        return
    if how == "micro":
        # each micro-batch of STACKED through forward (or engine(batch)),
        # backward and step on a fresh pair of engines (the shared pair
        # keeps its step count): the same losses, one step, the same
        # masters
        jeng, teng = _engine_pair()
        for k in range(2):
            micro = {key: v[k] for key, v in STACKED.items()}
            losses = []
            for eng in (teng, jeng):
                loss = eng(micro) if name == "__call__" else eng.forward(micro)
                eng.backward(loss)
                assert eng.is_gradient_accumulation_boundary() == (k == 1)
                eng.step()
                losses.append(float(loss))
            np.testing.assert_allclose(*losses, rtol=1e-5)
        assert teng.global_steps == jeng.global_steps
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
        want = _flat(jax.tree.map(np.asarray, jeng.get_params()))
        got = _flat(teng.get_params())
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        return
    if args is None:                                # a property
        assert getattr(teng, name) == getattr(jeng, name)
        return
    if name == "stack_microbatches":
        got = teng.stack_microbatches(iter([BATCH, BATCH]), 2)
        want = jeng.stack_microbatches(iter([BATCH, BATCH]), 2)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        return
    got, want = getattr(teng, name)(*args), getattr(jeng, name)(*args)
    if how == "self":
        assert got is teng and want is jeng
        assert teng.training == jeng.training
        teng.train(), jeng.train()
    elif how == "loss":
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    elif how == "lr":             # the reference's is an fp32 scalar
        np.testing.assert_allclose(got, want, rtol=1e-6)
    elif how == "close":
        np.testing.assert_allclose(got, want, rtol=1e-4)
    elif how == "equal":
        assert got == want
    elif how == "tree":
        if name == "module_state_dict":
            got = {k.replace(".", "/"): v.numpy() for k, v in got.items()}
        else:
            got = _flat(got)
        want = _flat(jax.tree.map(np.asarray, want))
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=1e-5,
                                       err_msg=k)


def test_offload_trainer_surface_answers_as_jax():
    jcfg, tcfg, params = _configs()
    jcfg = dataclasses.replace(jcfg, num_layers=2)
    config = {"train_batch_size": 2, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": 0,
                                    "offload_param": {"device": "cpu"}}}
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng, *_ = deepspeed_tpu.initialize(
            model=jllama.LlamaForCausalLM(jcfg), config=dict(config),
            model_parameters=params, mesh=mesh)
        teng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(tcfg, device="cpu"),
            config=dict(config), model_parameters=params, device="cpu")
    jpo, tpo = jeng._param_offload, teng._param_offload
    leaves = ["/".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  jpo.masters_tree())[0]]
    assert sorted(n.replace(".", "/") for n in tpo.treedef) == sorted(leaves)
    assert jpo.treedef.num_leaves == len(tpo.treedef)
    want, got = _flat(jpo.masters_tree()), _flat(tpo.masters_tree())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # load_masters: the same perturbed tree lands on both sides
    moved = jax.tree.map(lambda a: np.asarray(a) * 0.5, jpo.masters_tree())
    jpo.load_masters(moved)
    tpo.load_masters(moved)
    want, got = _flat(jpo.masters_tree()), _flat(tpo.masters_tree())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(_flat(teng.get_params())[k], want[k])
    tpo.sync_store()
    batch = jllama.random_tokens(2, 16, vocab_size=512, seed=7)
    np.testing.assert_allclose(float(teng.train_batch(batch=batch)),
                               float(jeng.train_batch(batch=batch)), rtol=1e-4)
    tpo.close()


@pytest.mark.parametrize("name", PACKAGE)
def test_package_surface_answers_as_jax_or_names_its_item(name):
    ours = getattr(deepspeed_tpu_torch, name)
    if name == "get_accelerator":
        assert _waits(ours)
    elif name == "init_inference":
        # both packages' v1 engines at tp_size 1 on the same flax params
        # serve the same logits
        jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32)
        jmodel = jllama.LlamaForCausalLM(jcfg)
        batch = jllama.random_tokens(2, 16, vocab_size=512, seed=3)
        params = jax.tree.map(np.asarray, jmodel.init(
            jax.random.PRNGKey(0), batch)["params"])
        config = {"dtype": "fp32", "tensor_parallel": {"tp_size": 1}}
        want = getattr(deepspeed_tpu, name)(
            lambda p, b: jmodel.apply({"params": p}, b,
                                      method=jllama.LlamaForCausalLM.logits),
            config=config, params=params).forward(batch)
        tcfg = dataclasses.replace(tllama.TINY_LLAMA, dtype=torch.float32)
        eng = ours(tllama.LlamaForCausalLM(tcfg, device="cpu"),
                   config=config, params=params, device="cpu")
        np.testing.assert_allclose(eng.forward(batch).numpy(),
                                   np.asarray(want), atol=2e-4, rtol=1e-4)
        assert eng.config.tp_size == 1 and eng.mesh.size == 1
    elif name == "add_config_arguments":
        argv = ["--deepspeed", "--deepspeed_config", "ds.json"]
        got = vars(ours(argparse.ArgumentParser()).parse_args(argv))
        want = vars(getattr(deepspeed_tpu, name)(
            argparse.ArgumentParser()).parse_args(argv))
        assert got == want
    elif name == "initialize":
        import inspect
        assert "mesh" in inspect.signature(ours).parameters
        # training_data: both return the loader of global micro-batches
        from deepspeed_tpu.models import simple as jsimple
        from deepspeed_tpu_torch.models import simple as tsimple
        # (8 rows a global micro-batch: JAX's over its 8 CPU devices)
        config = {"train_batch_size": 8, "gradient_accumulation_steps": 1}
        _, _, want, _ = getattr(deepspeed_tpu, name)(
            model=jsimple.SimpleModel(hidden_dim=16), config=dict(config),
            training_data=jsimple.random_dataset(20),
            example_batch=jsimple.random_batch(8))
        _, _, got, _ = ours(model=tsimple.SimpleModel(16, device="cpu"),
                            config=dict(config), device="cpu",
                            training_data=tsimple.random_dataset(20))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    elif name == "logger":
        assert ours.name == "deepspeed_tpu_torch"
    elif name == "log_dist":
        ours("api surface check", ranks=[0])
    else:
        assert ours.__name__ == name
    assert "jax" not in getattr(ours, "__module__", "") or name == "logger"


def test_server_membership_names_its_item():
    from deepspeed_tpu_torch.serving.server import InferenceServer
    with pytest.raises(NotImplementedError, match="Queue 1 item 6b"):
        InferenceServer(engine=None, membership=object())


ITEM_6B_CALLS = ["FaultTolerantRunner", "StepGuard", "StepWatchdog",
                 "MembershipView", "ResilienceConfig", "nan_due",
                 "corrupt_batch", "maybe_stall", "comm_fault", "peer_dead",
                 "maybe_oom", "maybe_die"]


@pytest.mark.parametrize("name", ITEM_6B_CALLS)
def test_item_6b_calls_name_their_item(name):
    """The resilience runner's classes (its SIGTERM autosave with it) and
    chaos's training knobs wait for item 6b; the JAX package has each."""
    import deepspeed_tpu.resilience as jres
    from deepspeed_tpu.resilience.chaos import ChaosMonkey as JMonkey
    from deepspeed_tpu_torch import resilience
    if hasattr(JMonkey, name):
        fn = getattr(resilience.ChaosMonkey(resilience.ChaosConfig()), name)
        args = {"nan_due": (0,), "corrupt_batch": ({}, 0),
                "maybe_stall": (0,), "comm_fault": ("all_reduce", 0),
                "peer_dead": (0,), "maybe_oom": (0,), "maybe_die": (0,)}[name]
    else:
        assert hasattr(jres, name)
        fn, args = getattr(resilience, name), ()
    with pytest.raises(NotImplementedError, match="Queue 1 item 6b"):
        fn(*args)
