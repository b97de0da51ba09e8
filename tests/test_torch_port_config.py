"""The port's copy of the configuration against the JAX package's: the same
Options fields and defaults, every preset equal, and the same validation.
Tests that hand JAX `Options` to port functions rely on this."""

import dataclasses

import pytest

from pointnerf_tpu import config as jconfig
from pointnerf_tpu_torch import config as tconfig


def test_options_fields_and_defaults_match():
    jf = {f.name: f for f in dataclasses.fields(jconfig.Options)}
    tf = {f.name: f for f in dataclasses.fields(tconfig.Options)}
    assert list(jf) == list(tf)
    assert dataclasses.asdict(jconfig.Options()) == \
        dataclasses.asdict(tconfig.Options())
    opt = tconfig.Options().replace(fused_shade=1, K=4)
    assert (opt.fused_shade, opt.K) == (1, 4)
    assert tconfig.Options.from_json(opt.to_json()) == opt


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_match(name):
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    want = dataclasses.asdict(jconfig.PRESETS[name]())
    got = dataclasses.asdict(tconfig.PRESETS[name]())
    assert got == want


def test_validate_options_matches():
    ok = tconfig.nerf_synth_preset("lego").replace(gpu_ids=(0, 1))
    assert tconfig.validate_options(ok).n_devices == 2
    for bad in (dict(alpha_range=1), dict(NN=0),
                dict(color_loss_weights=(1.0, 2.0))):
        with pytest.raises((NotImplementedError, ValueError)) as want:
            jconfig.validate_options(jconfig.Options(**bad))
        with pytest.raises(want.type):
            tconfig.validate_options(tconfig.Options(**bad))
