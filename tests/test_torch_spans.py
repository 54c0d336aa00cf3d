"""The port's profiler ranges (`repro_torch.spans`), on the CPU at smoke width.

A smoke granite-8b (a dense decoder, three layers) under each remat policy:

  * under `torch.profiler.profile`, a prefill enters ``attention.core`` and
    ``mlp`` once a layer; a training step with 2 microbatches enters
    ``optim.update`` once, ``train.grads`` 2·2 + 1 times (each
    microbatch's bfloat16 cast, the accumulation's add and 1/n scale, the
    float32 cast and clip), and ``attention.core`` and ``mlp`` once a layer
    and microbatch, twice under remat (the forward and the recompute);
  * ``flash_attention.backward`` keeps its name, once a layer and microbatch;
  * with no profiler on, neither path opens a `record_function`;
  * the step's loss, gradient norm and updated parameters are bit-equal with
    the profiler on and off.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import smoke
from repro_torch.models.model import Model
from repro_torch.models.spec import flatten
from repro_torch.runtime.steps import init_train_state, make_train_step

LAYERS, MICRO, B, T = 3, 2, 4, 32
POLICIES = ("none", "dots", "full")
NAMES = {spans.ATTENTION_CORE, spans.MLP, spans.TRAIN_GRADS, spans.OPTIM_UPDATE,
         spans.FLASH_ATTENTION_BACKWARD, spans.SSD_DIAG_BACKWARD}


def _spec(remat: str, attention_impl: str = "auto"):
    spec = smoke("granite-8b")
    model = spec.model.replace(num_layers=LAYERS, remat_policy=remat,
                               attention_impl=attention_impl)
    return model, spec.exec.replace(num_microbatches=MICRO, bf16_grad_reduce=True)


def _tokens(cfg, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, T), generator=g)


def _train_step(remat: str, attention_impl: str = "auto"):
    cfg, ex = _spec(remat, attention_impl)
    model = Model(cfg, device="cpu", seed=0)
    state = init_train_state(model, ex)
    step = make_train_step(model, ex)
    return lambda: step(state, {"tokens": _tokens(cfg)})


def _prefill():
    cfg, _ = _spec("none")
    model = Model(cfg, device="cpu", seed=0)

    @torch.no_grad()
    def run():
        return model.prefill({"tokens": _tokens(cfg)}, model.init_cache(B, T))

    return run


def _entered(fn) -> collections.Counter:
    """How many times ``fn`` enters each of the program's ranges, as the
    profiler records them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                               if e.name() in NAMES)


def test_prefill_enters_attention_core_and_mlp_once_a_layer():
    got = _entered(_prefill())
    assert got == {spans.ATTENTION_CORE: LAYERS, spans.MLP: LAYERS}


@pytest.mark.parametrize("remat", POLICIES)
def test_train_step_enters_each_range_as_often_as_it_runs(remat):
    once = LAYERS * MICRO * (1 if remat == "none" else 2)  # the recompute enters again
    got = _entered(_train_step(remat))
    assert got == {spans.ATTENTION_CORE: once, spans.MLP: once,
                   spans.TRAIN_GRADS: 2 * MICRO + 1, spans.OPTIM_UPDATE: 1}


def test_flash_attention_backward_keeps_its_name():
    assert spans.FLASH_ATTENTION_BACKWARD == "flash_attention.backward"
    assert spans.SSD_DIAG_BACKWARD == "ssd_diag.backward"
    got = _entered(_train_step("full", attention_impl="pallas"))
    assert got[spans.FLASH_ATTENTION_BACKWARD] == LAYERS * MICRO
    assert got[spans.ATTENTION_CORE] == 2 * LAYERS * MICRO


@pytest.mark.parametrize("path", ["prefill", "train_step"])
def test_no_profiler_enters_no_record_function(path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function opened with no profiler on")

    run = _prefill() if path == "prefill" else _train_step("full", attention_impl="pallas")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    run()


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_train_step_is_bit_equal_with_the_profiler_on_and_off(remat):
    def one(profiled: bool):
        cfg, ex = _spec(remat)
        model = Model(cfg, device="cpu", seed=0)
        state = init_train_state(model, ex)
        step = make_train_step(model, ex)
        batch = {"tokens": _tokens(cfg)}
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                state, metrics = step(state, batch)
        else:
            state, metrics = step(state, batch)
        return state, metrics

    (s_on, m_on), (s_off, m_off) = one(True), one(False)
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert torch.equal(m_on["grad_norm"], m_off["grad_norm"])
    for a, b in zip(flatten(s_on["params"]), flatten(s_off["params"]), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(flatten(s_on["opt"].inner), flatten(s_off["opt"].inner), strict=True):
        assert torch.equal(a, b)
