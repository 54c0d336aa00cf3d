"""The yardstick's arithmetic: the frozen bound and peaks against
`chip_smoke.py`'s, and the MFU's matrix-product count against the program's
step counter."""

import importlib.util

import pytest

from portbench import counts, harness

SHAPES_FLASH = [(1, 4096, 32, 8, 128, True, 2), (2, 4096, 32, 32, 64, True, 2),
                (4, 512, 6, 6, 64, False, 4), (1, 333, 8, 2, 16, True, 4)]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", harness.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", SHAPES_FLASH)
def test_flash_bound_is_chip_smokes(chip_smoke, shape):
    want = chip_smoke.flash_bound(*shape)
    assert counts.flash_bound(*shape) == {k: want[k] for k in ("bytes", "flops", "bound_ms",
                                                               "bound_by")}


def test_peaks_are_chip_smokes(chip_smoke):
    for k in ("PEAK_BYTES_PER_S", "PEAK_FP32_PER_S", "PEAK_BF16_PER_S"):
        assert getattr(counts, k) == getattr(chip_smoke, k)


def test_matmul_count_is_the_step_counters():
    """At smoke width, with remat off, the program's forward counted by
    `launch.hlo_analysis.StepCounter` (every product it runs, attention's
    as full T x S blocks on the dense route) equals this count's products
    plus the attention blocks' full-square products."""
    import torch
    from smoke import smoke_config

    from portbench import weights
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.models.model import Model

    c = smoke_config("granite-8b-12l", remat_policy="none")
    cfg = harness.port_model_config(c).replace(attention_impl="dense")
    model = Model(cfg, params=weights.nest(weights.draw(c, 0, "cpu", served=False)), device="cpu")
    b, t = 2, 64
    tokens = torch.randint(0, c["vocab_size"], (b, t))
    with torch.no_grad(), StepCounter() as counter:
        model.forward({"tokens": tokens})
    f = counts.forward_flops(c, b, t)
    square = c["num_layers"] * 4.0 * b * c["num_heads"] * t * t * c["head_dim"]
    assert counter.cost.flops == pytest.approx(f["matmul"] + square, rel=1e-9)


def test_itemsize_matches_the_cells_dtypes():
    c = harness.config("granite-8b-12l")
    (shape, n), = counts.k2_calls_train(c, 2, 4096, 2)
    assert shape[-1] == 2 and c["compute_dtype"] == "bfloat16"
    assert n == 2 * 2 * 12


@pytest.mark.parametrize("name", ["granite-8b-12l", "granite-8b"])
def test_each_family_has_its_modules(name):
    """A configuration's family names a count module and a reference module,
    found by that name, with what the harness calls on them."""
    from portbench import reference

    c = harness.config(name)
    assert callable(counts.family(c).forward_flops) and counts.family(c).attention_layers(c) > 0
    fam = reference.family(c)
    for attr in ("layout", "prefill", "microbatch_loss"):
        assert callable(getattr(fam, attr)), attr
    assert set(fam.CACHE_KEYS) == {k for names in fam.STATE_NUMBERS.values() for k in names}
