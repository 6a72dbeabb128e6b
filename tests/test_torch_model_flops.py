"""The port's step-roofline inputs against the reference on the CPU:
``SHAPES`` and ``ASSIGNED_LM_ARCHS``, ``num_active_params`` and
``model_flops`` for every arch x shape (exactly), ``input_specs`` /
``dlrm_input_specs`` (shapes and dtypes, as meta tensors), every family's
``init_abstract`` tree (keys, shapes, dtypes against the port's ``init``
and the reference's ``init_abstract``), and ``RooflineReport.to_dict``'s
keys with its terms on the H100's constants."""
import dataclasses

import pytest
import torch

from repro_torch.config import SHAPES, get_config
from repro_torch.configs import ASSIGNED_LM_ARCHS
from repro_torch.models.api import build_model, dlrm_input_specs, input_specs
from repro_torch.roofline.analysis import H100, RooflineReport
from repro_torch.roofline.model_flops import model_flops

CELLS = [(a, s) for a in ASSIGNED_LM_ARCHS for s in SHAPES]
# one config of each family, reduced as the reference reduces it
FAMILIES = ["smollm-360m", "granite-moe-1b-a400m", "internvl2-26b",
            "rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny"]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _leaves(tree, path=()):
    """{path: (shape, dtype name)} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (i,)))
        return out
    return {path: (tuple(tree.shape), _dtype_name(tree.dtype))}


def test_shapes_and_archs_equal_the_reference():
    from repro import config as jconfig
    from repro.configs import ASSIGNED_LM_ARCHS as jarchs

    assert ASSIGNED_LM_ARCHS == jarchs
    assert list(SHAPES) == list(jconfig.SHAPES)
    for name, cell in SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            jconfig.SHAPES[name])


@pytest.mark.parametrize("arch", ASSIGNED_LM_ARCHS + ["llama31-8b",
                                                       "llama31-70b"])
def test_num_active_params_equals_the_reference(arch):
    from repro.config import get_config as jget

    assert get_config(arch).num_active_params() == \
        jget(arch).num_active_params()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equals_the_reference(arch, shape):
    from repro.config import SHAPES as jshapes
    from repro.config import get_config as jget
    from repro.roofline.model_flops import model_flops as jflops

    got = model_flops(get_config(arch), SHAPES[shape])
    assert got == jflops(jget(arch), jshapes[shape])
    assert got > 0


@pytest.mark.parametrize("arch", ASSIGNED_LM_ARCHS)
def test_input_specs_match_the_reference(arch):
    from repro.config import SHAPES as jshapes
    from repro.config import get_config as jget
    from repro.models.api import input_specs as jspecs

    for shape in SHAPES:
        got = input_specs(get_config(arch), SHAPES[shape])
        want = jspecs(jget(arch), jshapes[shape])
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (shape, k)
            # the port keeps the reference's int32 tokens and bf16 stubs
            assert _dtype_name(t.dtype) == str(want[k].dtype), (shape, k)


@pytest.mark.parametrize("arch", ["rm1", "rm2"])
def test_dlrm_input_specs_match_the_reference(arch):
    from repro.config import get_config as jget
    from repro.models.api import dlrm_input_specs as jspecs

    got, want = dlrm_input_specs(get_config(arch), 64), jspecs(jget(arch), 64)
    assert {k: (tuple(t.shape), _dtype_name(t.dtype), t.device.type)
            for k, t in got.items()} == \
        {k: (tuple(s.shape), str(s.dtype), "meta") for k, s in want.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_abstract_equals_init_and_the_reference(arch):
    from repro.config import get_config as jget
    from repro.models.api import build_model as jbuild

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    abstract = model.init_abstract()
    assert {t.device.type for t in _flat(abstract)} == {"meta"}
    assert _leaves(abstract) == _leaves(model.init(0))
    assert _leaves(abstract) == _leaves(
        jbuild(jget(arch).reduced()).init_abstract())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dlrm_init_abstract_takes_a_dtype(dtype):
    import jax.numpy as jnp
    from repro.config import get_config as jget
    from repro.models.api import build_model as jbuild

    cfg = dataclasses.replace(get_config("rm1"), num_embeddings=64)
    jcfg = dataclasses.replace(jget("rm1"), num_embeddings=64)
    model = build_model(cfg, device="cpu")
    abstract = model.init_abstract(dtype)
    want = jbuild(jcfg).init_abstract(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    assert _leaves(abstract) == _leaves(want)
    shapes = {k: v[0] for k, v in _leaves(abstract).items()}
    assert shapes == {k: v[0] for k, v in _leaves(model.init(0)).items()}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_roofline_report_keys_and_h100_terms():
    from repro.roofline.analysis import RooflineReport as JReport

    kw = dict(arch="a", shape="s", mesh="1", chips=1, hlo_flops=2e15,
              hlo_bytes=6.7e12, collective_bytes=0.0, model_flops=1.5e15)
    got = RooflineReport(**kw).to_dict()
    assert list(got) == list(JReport(**kw).to_dict())
    assert got["t_compute"] == 2e15 / H100.peak_bf16
    assert got["t_memory"] == 6.7e12 / H100.hbm_bw
    assert got["bottleneck"] == "compute"
    assert got["useful_flops_ratio"] == 0.75
    assert got["mfu"] == pytest.approx(0.75)
    f32 = RooflineReport(**kw, dtype=torch.float32)
    assert f32.t_compute == 2e15 / H100.peak_f32
    coll = RooflineReport(**dict(kw, collective_bytes=9e12))
    assert coll.t_collective == 9e12 / H100.nvlink_bw
    assert coll.bottleneck == "collective"
