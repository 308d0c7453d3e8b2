"""The port's universal-checkpoint tools (``deepspeed_tpu_torch/checkpoint/
universal.py``) against the JAX package's (counterpart of
``tests/test_universal_checkpoint.py``), on ``TINY_LLAMA`` in fp32 from the
same flax weights on both sides:

- ``resolve_checkpoint_dir``, ``inspect_checkpoint`` (the inventory and the
  provenance summary, from the files' headers), ``extract_param``,
  ``compat_check``;
- ``consolidate_to_fp32``: the ``params/`` keys and shapes letter for
  letter the JAX package's for the same model, the values the masters,
  the archive the one ``np.savez`` writes of them, member for member;
- a JAX-consolidated npz through the port's ``serving/cli.py
  --checkpoint`` path: the prefill's last-token logits within atol 2e-4 /
  rtol 1e-4 of the JAX model's (the tolerance of the v1 engine's check in
  ``tests/test_torch_api_surface.py``); the port's npz read by the JAX
  package's ``load_fp32_state`` gives the port's masters bit for bit;
- the CLI ``main``: ``inspect`` (``--compat``: exit 0 / 1) and
  ``consolidate``.
"""

import dataclasses
import json
import zipfile

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu.checkpoint import universal as juni  # noqa: E402
from deepspeed_tpu.comm.mesh import create_mesh  # noqa: E402
from deepspeed_tpu.config.config import MeshConfig  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu_torch.checkpoint import universal as uni  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.serving import cli  # noqa: E402

CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def _cfgs():
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla")
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One step of each package's engine from the same flax weights, each
    saved as ``step1`` by its own package."""
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, 512))["params"])
    batch = jllama.random_tokens(2, 16, vocab_size=512, seed=4, gas=2)
    root = tmp_path_factory.mktemp("universal")
    jeng, *_ = deepspeed_tpu.initialize(
        model=jllama.LlamaForCausalLM(jcfg), config=dict(CONFIG),
        model_parameters=params,
        mesh=create_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
    jeng.train_batch(batch=batch, stacked=True)
    jeng.save_checkpoint(str(root / "jax"), tag="step1")
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaForCausalLM(tcfg, device="cpu"),
        config=dict(CONFIG), model_parameters=params, device="cpu")
    teng.train_batch(batch=batch, stacked=True)
    teng.save_checkpoint(str(root / "port"), tag="step1")
    return root, jeng, teng


def test_resolve_by_tag_and_latest(saved):
    root, _, _ = saved
    d = str(root / "port")
    by_tag = uni.resolve_checkpoint_dir(d, tag="step1")
    assert by_tag == uni.resolve_checkpoint_dir(d) == \
        uni.resolve_checkpoint_dir(by_tag)
    assert by_tag.endswith("step1")
    with pytest.raises(FileNotFoundError):
        uni.resolve_checkpoint_dir(str(root / "nonexistent"))
    with pytest.raises(FileNotFoundError):
        uni.resolve_checkpoint_dir(d, tag="step9")


def test_inspect_lists_all_params(saved):
    root, _, teng = saved
    info = uni.inspect_checkpoint(str(root / "port"))
    masters = {n.replace(".", "/"): p for n, p in teng.named_masters()}
    assert info["parameters"] == {
        n: {"shape": list(p.shape), "dtype": "float32"}
        for n, p in sorted(masters.items())}
    assert info["num_params"] == sum(p.numel() for p in masters.values())
    assert info["meta"]["global_steps"] == 1
    summary = info["provenance"]
    assert summary["step"] == 1 and summary["zero"]["stage"] == 0
    assert summary["mesh_axes"] == {"(all axes 1)": 1}
    assert summary["sampler"]["consumed_samples"] == 4
    assert summary["rng_key"]["shape"] == list(torch.get_rng_state().shape)
    jinfo = juni.inspect_checkpoint(str(root / "jax"))
    assert {k: v["shape"] for k, v in info["parameters"].items()} == \
        {k: list(v["shape"]) for k, v in jinfo["parameters"].items()}


def test_consolidate_keys_match_jax_letter_for_letter(saved, tmp_path):
    root, _, teng = saved
    port_npz = uni.consolidate_to_fp32(str(root / "port"),
                                       str(tmp_path / "port"))
    port = np.load(port_npz)
    ref = np.load(juni.consolidate_to_fp32(str(root / "jax"),
                                           str(tmp_path / "jax")))
    assert sorted(port.files) == sorted(ref.files)
    for k in ref.files:
        assert port[k].shape == ref[k].shape and port[k].dtype == np.float32
    for n, p in teng.named_masters():
        np.testing.assert_array_equal(port["params/" + n.replace(".", "/")],
                                      p.detach().numpy())
    # each member is np.savez's: the npz equals one np.savez writes
    again = tmp_path / "savez.npz"
    np.savez(again, **{k: port[k] for k in port.files})
    with zipfile.ZipFile(port_npz) as a, zipfile.ZipFile(again) as b:
        assert a.testzip() is None
        for name in b.namelist():
            assert a.read(name) == b.read(name), name


def test_consolidate_with_optimizer(saved, tmp_path):
    root, _, teng = saved
    data = np.load(uni.consolidate_to_fp32(str(root / "port"),
                                           str(tmp_path / "full"),
                                           include_optimizer=True))
    opt = [k for k in data.files if k.startswith("opt_state/")]
    assert len(opt) == 2 * len(teng._paths)
    np.testing.assert_array_equal(
        data["opt_state/mu/model/final_norm/scale"],
        teng.optimizer.mu[teng._paths.index("model/final_norm/scale")].numpy())


def test_extract_param(saved):
    root, _, teng = saved
    d = str(root / "port")
    name = "model/layer_1/attn/wq/kernel"
    arr = uni.extract_param(d, name)
    np.testing.assert_array_equal(
        arr, dict(teng.named_masters())[name.replace("/", ".")].detach().numpy())
    with pytest.raises(KeyError, match="closest"):
        uni.extract_param(d, "layer_1/attn/wq")


def _last_logits(eng, tokens):
    import chip_smoke
    return chip_smoke.prefill_decode_logits(eng, tokens, "auto")[0].numpy()


def test_jax_npz_serves_through_the_port_cli(saved, tmp_path):
    root, jeng, teng = saved
    jcfg, tcfg = _cfgs()
    npz = juni.consolidate_to_fp32(str(root / "jax"), str(tmp_path / "jax"))
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    eng = InferenceEngineV2(cli.checkpoint_params(npz, tcfg, "cpu"), tcfg,
                            V2EngineConfig(kv_block_size=64,
                                           kv_num_blocks=8), device="cpu")
    tokens = list(np.random.default_rng(3).integers(0, 512, 12))
    want = jllama.LlamaForCausalLM(jcfg).apply(
        {"params": jeng.get_params()}, {"input_ids": np.asarray([tokens])},
        method=jllama.LlamaForCausalLM.logits)
    np.testing.assert_allclose(_last_logits(eng, tokens),
                               np.asarray(want)[0, -1], atol=2e-4, rtol=1e-4)
    # the CLI's own path at the preset's dtype serves the same npz
    args = cli.build_parser().parse_args(
        ["--preset", "TINY_LLAMA", "--checkpoint", npz, "--device", "cpu",
         "--kv-num-blocks", "8"])
    served = cli.build_engine(args)
    assert served.model_config.num_layers == tcfg.num_layers
    out = served.generate(tokens, max_new_tokens=4)
    assert len(out) == 4 and all(0 <= t < 512 for t in out)
    # and the port's npz in the JAX package: the port's masters
    port_npz = uni.consolidate_to_fp32(str(root / "port"),
                                       str(tmp_path / "port"))
    state = juni.load_fp32_state(port_npz)
    for n, p in teng.named_masters():
        np.testing.assert_array_equal(state[n.replace(".", "/")],
                                      p.detach().numpy())


def test_compat_check_reports_feasibility(saved):
    root, _, _ = saved
    d = str(root / "port")
    ok = uni.compat_check(d, world=4)
    assert ok["feasible"] and ok["checks"]["batch"]["ok"]
    assert ok["checks"]["ledger"]["ok"]
    bad = uni.compat_check(d, world=3)          # 4 % 3 != 0
    assert not bad["feasible"] and not bad["checks"]["batch"]["ok"]


def test_cli_inspect_and_consolidate(saved, tmp_path, capsys):
    root, _, _ = saved
    d = str(root / "port")
    assert uni.main(["inspect", d]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["num_params"] > 0 and info["provenance"]["step"] == 1
    assert uni.main(["inspect", d, "--compat", "4"]) == 0
    capsys.readouterr()
    assert uni.main(["inspect", d, "--compat", "3"]) == 1
    capsys.readouterr()
    out = str(tmp_path / "model.npz")
    assert uni.main(["consolidate", d, out, "--tag", "step1"]) == 0
    assert capsys.readouterr().out.strip() == out
    assert len(uni.load_fp32_state(out)) == len(info["parameters"])


def test_load_fp32_state_reads_what_np_load_reads(tmp_path, monkeypatch):
    """The port's reader: the ``params/`` members of an ``np.savez``
    archive, in C and Fortran order, a scalar, an empty array, another
    dtype, as ``np.load`` gives them, read in 256-byte pieces whose CRC32s
    combine to the archive's, so a flipped byte raises; a compressed
    archive is refused."""
    monkeypatch.setattr(uni, "COPY_BYTES", 256)
    rng = np.random.default_rng(5)
    arrays = {"params/a/w": rng.standard_normal((30, 7)).astype(np.float32),
              "params/a/f": np.asfortranarray(rng.standard_normal((3, 4))),
              "params/e": np.zeros((0, 3), np.float32),
              "params/s": np.float32(3.5), "opt_state/mu/s": np.ones(2)}
    path = tmp_path / "m.npz"
    np.savez(path, **arrays)
    got = uni.load_fp32_state(str(path))
    assert sorted(got) == ["a/f", "a/w", "e", "s"]
    for k, v in got.items():
        want = arrays["params/" + k]
        assert v.dtype == want.dtype and v.shape == np.shape(want)
        np.testing.assert_array_equal(v, want)
    np.savez_compressed(tmp_path / "z.npz", **arrays)
    with pytest.raises(ValueError, match="compressed"):
        uni.load_fp32_state(str(tmp_path / "z.npz"))
    data = bytearray(path.read_bytes())
    data[data.find(arrays["params/a/w"].tobytes()[:64]) + 9] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        uni.load_fp32_state(str(path))
