"""The port's checkpoint policy (``deepspeed_tpu_torch/resilience/
checkpointing.py``) and chaos's checkpoint-I/O knob, on the CPU
(counterpart of ``tests/test_resilience.py:137-212`` and ``:518``; the JAX
tests drive them through the resilience runner, item 6b here, so these
call ``save_with_retry``, ``resume_from_latest`` and ``Autosaver``
directly):

- ``save_with_retry`` retries the injected failures of
  ``ChaosConfig(ckpt_fail_first=2)`` and commits; with the retry budget
  exhausted it raises ``CheckpointSaveError`` and nothing is committed;
- a tag torn after its commit (a flipped byte) and a newer uncommitted tag
  are skipped by ``find_latest_committed``; a tag torn before its
  manifest landed (``ds_meta.json`` only) fails its load, and
  ``resume_from_latest`` falls back to the older clean commit; a named
  torn tag raises ``CheckpointCorruptionError``;
- the ``Autosaver`` cadence and ``prune_checkpoints`` keep the newest N.
"""

import dataclasses
import json
import os

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.engine import (MANIFEST_FILE,
                                                   CheckpointCorruptionError,
                                                   is_committed)
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.resilience import (Autosaver, ChaosConfig,
                                            ChaosInjectedIOError, ChaosMonkey,
                                            CheckpointSaveError,
                                            find_latest_committed, list_tags,
                                            prune_checkpoints,
                                            resume_from_latest,
                                            save_with_retry)

CONFIG = {"train_batch_size": 2, "gradient_accumulation_steps": 1,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}


def _engine(seed=1):
    cfg = dataclasses.replace(tllama.TINY_LLAMA, dtype=torch.float32,
                              attention_backend="xla", num_layers=1)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tllama.LlamaForCausalLM(cfg, device="cpu", seed=seed),
        config=dict(CONFIG), device="cpu")
    return eng


def _step(eng, i=0):
    return float(eng.train_batch(batch=tllama.random_tokens(
        2, 16, vocab_size=512, seed=i)))


def _run(eng, ckpt_dir, steps, every=1, keep_last=0):
    """``steps`` steps, a ``save_with_retry`` whenever the autosaver is due
    (and a prune to ``keep_last``)."""
    saver = Autosaver(every_steps=every)
    for i in range(steps):
        _step(eng, i)
        if saver.due(eng.global_steps):
            save_with_retry(eng, ckpt_dir, backoff_s=0.01)
            saver.mark_saved(eng.global_steps)
            prune_checkpoints(ckpt_dir, keep_last)
    return saver


def test_ckpt_io_failure_retried_then_committed(tmp_path):
    eng = _engine()
    _step(eng)
    chaos = ChaosMonkey(ChaosConfig(seed=2, ckpt_fail_first=2))
    ckpt_dir = str(tmp_path / "ckpt")
    path = save_with_retry(eng, ckpt_dir, retries=3, backoff_s=0.01,
                           chaos=chaos)
    assert chaos.injected["ckpt"] == 2        # two injected failures consumed
    assert path.endswith("global_step1")
    tag = find_latest_committed(ckpt_dir)
    assert tag == "global_step1" and is_committed(ckpt_dir, tag)
    assert os.path.exists(os.path.join(ckpt_dir, tag, MANIFEST_FILE))


def test_ckpt_retry_budget_exhausted_raises(tmp_path):
    eng = _engine()
    _step(eng)
    chaos = ChaosMonkey(ChaosConfig(seed=2, ckpt_fail_first=99))
    with pytest.raises(CheckpointSaveError) as e:
        save_with_retry(eng, str(tmp_path / "ckpt"), retries=2,
                        backoff_s=0.01, chaos=chaos)
    assert isinstance(e.value.__cause__, ChaosInjectedIOError)
    assert chaos.injected["ckpt"] == 3
    assert find_latest_committed(str(tmp_path / "ckpt")) is None


def test_chaos_ckpt_knobs_from_env():
    cfg = ChaosConfig.from_env({"DSTPU_CHAOS_CKPT_FAIL_FIRST": "1",
                                "DSTPU_CHAOS_CKPT_FAIL_PROB": "0.5",
                                "DSTPU_CHAOS_SEED": "3"})
    assert (cfg.ckpt_fail_first, cfg.ckpt_fail_prob, cfg.seed) == (1, 0.5, 3)
    assert cfg.active and not ChaosConfig().active
    monkey = ChaosMonkey(cfg)
    with pytest.raises(ChaosInjectedIOError):
        monkey.ckpt_io_check(step=4, attempt=0)
    # later attempts fail by the seeded roll alone: the same on a replay
    rolls = [ChaosMonkey(cfg)._roll("ckpt", 4, salt=a) < 0.5
             for a in range(1, 6)]
    again = [monkey._roll("ckpt", 4, salt=a) < 0.5 for a in range(1, 6)]
    assert rolls == again


def test_torn_checkpoint_never_loaded_falls_back(tmp_path):
    """Corrupting the newest committed tag must fail verification and
    resume from the older clean tag — ``latest`` is a hint, not trusted."""
    ckpt_dir = str(tmp_path / "ckpt")
    eng = _engine(seed=1)
    _run(eng, ckpt_dir, 4, every=2)
    assert list_tags(ckpt_dir) == ["global_step4", "global_step2"]
    newest = os.path.join(ckpt_dir, "global_step4")
    with open(os.path.join(newest, MANIFEST_FILE)) as f:
        victim = sorted(json.load(f)["files"])[-1]
    with open(os.path.join(newest, victim), "r+b") as f:
        f.seek(128)
        f.write(b"\xde\xad\xbe\xef")
    probe = _engine(seed=9)
    with pytest.raises(CheckpointCorruptionError):
        probe.load_checkpoint(ckpt_dir, tag="global_step4")
    assert (tmp_path / "ckpt" / "latest").read_text() == "global_step4"
    assert find_latest_committed(ckpt_dir) == "global_step2"
    fresh = _engine(seed=5)
    tag, _ = resume_from_latest(fresh, ckpt_dir)
    assert tag == "global_step2" and fresh.global_steps == 2


def test_uncommitted_tag_ignored(tmp_path):
    """A tag dir without a commit (arrays written, sidecars and manifest
    never landed) is invisible to resume."""
    ckpt_dir = tmp_path / "ckpt"
    eng = _engine()
    _run(eng, str(ckpt_dir), 1)
    (ckpt_dir / "global_step99").mkdir()
    (ckpt_dir / "global_step99" / "junk.bin").write_bytes(b"x" * 16)
    assert find_latest_committed(str(ckpt_dir)) == "global_step1"


def test_resume_falls_back_past_tag_torn_before_manifest(tmp_path):
    """A tag torn before its manifest landed (``ds_meta.json``, no
    manifest, no leaf files) fails its load with a non-corruption error;
    resume still falls back to the older clean commit, and the engine is
    untouched by the failed attempt."""
    ckpt_dir = tmp_path / "ckpt"
    eng = _engine()
    _run(eng, str(ckpt_dir), 1)
    half = ckpt_dir / "global_step7"
    half.mkdir()
    (half / "ds_meta.json").write_text('{"global_steps": 7}')
    fresh = _engine(seed=4)
    tag, _ = resume_from_latest(fresh, str(ckpt_dir))
    assert tag == "global_step1" and fresh.global_steps == 1
    for (n, a), (_, b) in zip(eng.named_masters(), fresh.named_masters()):
        assert torch.equal(a, b), n
    assert resume_from_latest(_engine(), str(tmp_path / "empty")) == (None,
                                                                      {})


def test_autosave_cadence_and_prune(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    eng = _engine()
    saver = _run(eng, ckpt_dir, 5, every=1, keep_last=2)
    assert list_tags(ckpt_dir) == ["global_step5", "global_step4"]
    assert find_latest_committed(ckpt_dir) == "global_step5"
    assert saver.state_dict() == {"last_save_step": 5}
    assert not saver.due(5) and saver.due(6)
    timed = Autosaver(every_seconds=1e-9)
    assert timed.enabled and timed.due(0)
    assert not Autosaver().enabled and not Autosaver().due(100)
