"""The port's other model families against the JAX package's, float32 on
the CPU: RWKV6LM (rwkv6-1.6b), Zamba2LM (zamba2-2.7b, 4 layers: two groups
of two mamba layers behind the shared block), WhisperEncDec
(whisper-tiny) and the VLM TransformerLM (internvl2-26b), each at its
reduced size, with parameters initialised by JAX, every leaf perturbed
(norm scales, biases, decays, mixes, ``u``, ``A_log``, ``D``, ``dt_bias``
away from their constant init so that each counts) and bridged.

Each JAX reference is computed once per family.

* forward logits: atol 1e-4;
* ``loss``: rtol 1e-5; every gradient leaf: atol 5e-5, rtol 1e-4
  (float32 sums in another order); remat ``full`` and ``dots`` give the
  loss and gradients of no remat (atol 1e-6);
* 8 ``decode_step`` logits (whisper after ``prefill_cross``): atol 1e-4
  against JAX's decode on the same parameters, and atol 1e-3 against the
  port's own ``forward`` (the decode and chunked forms of the scans sum
  in different orders; the reference's own test allows 3e-3);
* ``make_prefill_step``'s last-position logits: atol 1e-4;
* ``make_serve_step``'s greedy stream over 12 steps equals JAX's;
* the port's ``init`` tree (structure, shapes and per-leaf dtypes) equals
  the reference's ``init``, in float32 and in bfloat16 (where the RWKV and
  SSM decay leaves stay float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.serving.steps import make_prefill_step as j_prefill_step
from repro.serving.steps import make_serve_step as j_serve_step
from repro_torch import tree as tree_lib
from repro_torch.config import get_config
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.rwkv6 import RWKV6LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import WhisperEncDec
from repro_torch.models.zamba2 import Zamba2LM
from repro_torch.serving.steps import make_prefill_step, make_serve_step
from repro_torch.training.train_step import loss_and_grads

ARCHS = ["rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny", "internvl2-26b"]
# prompt lengths: whole chunks of the RWKV time mix (32) and the reduced
# SSM chunk (16), two of each
SEQ = {"rwkv6-1.6b": 64, "zamba2-2.7b": 32, "whisper-tiny": 16,
       "internvl2-26b": 16}
CLASSES = {"rwkv6-1.6b": RWKV6LM, "zamba2-2.7b": Zamba2LM,
           "whisper-tiny": WhisperEncDec, "internvl2-26b": TransformerLM}
B, STEPS = 2, 8


def _overrides(arch):
    return {"num_layers": 4} if arch == "zamba2-2.7b" else {}


def _extra(cfg, rng):
    if cfg.family == "vlm":
        return rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)
                                   ).astype(np.float32) * 0.5
    if cfg.family == "audio":
        return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                   ).astype(np.float32)
    return None


def _new_cache(model, cfg, max_seq):
    return (model.init_decode_cache(B) if cfg.family == "ssm"
            else model.init_decode_cache(B, max_seq))


class Family:
    """One family's JAX model and outputs, and the port's model on the
    bridged parameters."""

    def __init__(self, arch):
        over = _overrides(arch)
        self.jcfg = jax_get_config(arch).reduced(dtype="float32", **over)
        self.cfg = get_config(arch).reduced(dtype="float32", **over)
        self.jmodel = jax_build_model(self.jcfg, remat=False)
        params_j = jax.jit(self.jmodel.init)(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        self.params_j = jax.tree.map(
            lambda x: x + jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                                      x.dtype), params_j)
        self.model = build_model(self.cfg, device="cpu", remat="none")
        self.params = params_from_numpy(
            jax.tree.map(np.asarray, self.params_j), device="cpu")
        rng = np.random.default_rng(2)
        S = SEQ[arch]
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S)).astype(
            np.int32)
        self.extra = _extra(self.cfg, rng)
        self.jbatch = {"tokens": jnp.asarray(self.tokens)}
        self.tbatch = {"tokens": torch.from_numpy(self.tokens)}
        if self.extra is not None:
            self.jbatch["extra_embeds"] = jnp.asarray(self.extra)
            self.tbatch["extra_embeds"] = torch.from_numpy(self.extra)
        self.logits_j = np.asarray(jax.jit(self.jmodel.forward)(
            self.params_j, self.jbatch["tokens"],
            self.jbatch.get("extra_embeds"))[0])
        self.loss_j, grads = jax.jit(jax.value_and_grad(self.jmodel.loss))(
            self.params_j, self.jbatch)
        self.grads_j = [np.asarray(g) for g in jax.tree.leaves(grads)]
        self.prefill_j = np.asarray(jax.jit(j_prefill_step(self.jmodel))(
            self.params_j, self.jbatch))
        self.decode_j = self._jax_decode()
        self.stream_j = self._jax_stream()

    def _jax_cache(self, max_seq):
        cache = _new_cache(self.jmodel, self.cfg, max_seq)
        if self.cfg.family == "audio":
            cache = self.jmodel.prefill_cross(
                self.params_j, cache, self.jbatch["extra_embeds"])
        return cache

    def _jax_decode(self):
        cache = self._jax_cache(16)
        step = jax.jit(self.jmodel.decode_step)
        outs = []
        for t in range(STEPS):
            lg, cache = step(self.params_j, cache,
                             self.jbatch["tokens"][:, t])
            outs.append(np.asarray(lg))
        return np.stack(outs, 1)

    def _jax_stream(self):
        step = jax.jit(j_serve_step(self.jmodel))
        cache = self._jax_cache(16)
        tok = self.jbatch["tokens"][:, 0]
        out = []
        for _ in range(12):
            tok, cache = step(self.params_j, cache, tok)
            out.append(np.asarray(tok))
        return np.stack(out, 1)

    def cache(self, max_seq):
        cache = _new_cache(self.model, self.cfg, max_seq)
        if self.cfg.family == "audio":
            cache = self.model.prefill_cross(
                self.params, cache, self.tbatch["extra_embeds"])
        return cache


_FAMILIES = {}


def _family(arch):
    if arch not in _FAMILIES:
        _FAMILIES[arch] = Family(arch)
    return _FAMILIES[arch]


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return _family(request.param)


def test_build_model_picks_the_family(fam):
    assert type(fam.model) is CLASSES[fam.cfg.name]


def test_forward_matches_jax(fam):
    with torch.no_grad():
        got, aux = fam.model.forward(fam.params, fam.tbatch["tokens"],
                                     fam.tbatch.get("extra_embeds"))
    assert got.shape == fam.logits_j.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fam.logits_j, atol=1e-4)
    assert float(aux) == 0.0


def test_loss_and_grads_match_jax(fam):
    got, grads = loss_and_grads(fam.model.loss, fam.params, fam.tbatch)
    np.testing.assert_allclose(float(got), float(fam.loss_j), rtol=1e-5)
    gt = tree_lib.leaves(grads)
    assert len(gt) == len(fam.grads_j)
    for a, b in zip(gt, fam.grads_j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_gives_the_same_loss_and_grads(fam, mode):
    """The layers (zamba2: the groups; whisper: encoder and decoder
    layers) under remat recompute the same float32 ops: atol 1e-6."""
    want, grads = loss_and_grads(fam.model.loss, fam.params, fam.tbatch)
    model = build_model(fam.cfg, device="cpu", remat=mode)
    got, grads_r = loss_and_grads(model.loss, fam.params, fam.tbatch)
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    for a, b in zip(tree_lib.leaves(grads_r), tree_lib.leaves(grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_decode_matches_jax_and_the_forward(fam):
    cache = fam.cache(16)
    outs = []
    with torch.no_grad():
        for t in range(STEPS):
            lg, cache = fam.model.decode_step(
                fam.params, cache, fam.tbatch["tokens"][:, t])
            outs.append(lg)
        own, _ = fam.model.forward(fam.params, fam.tbatch["tokens"],
                                   fam.tbatch.get("extra_embeds"))
    got = torch.stack(outs, 1).numpy()
    np.testing.assert_allclose(got, fam.decode_j, atol=1e-4)
    # the VLM's forward holds the vision positions first; decode has none
    want = own[:, :STEPS] if fam.cfg.family != "vlm" else None
    if want is not None:
        np.testing.assert_allclose(got, want.numpy(), atol=1e-3)
    assert cache["seq_lens"].tolist() == [STEPS] * B


def test_prefill_step_matches_jax(fam):
    with torch.no_grad():
        got = make_prefill_step(fam.model)(fam.params, fam.tbatch)
    assert got.shape == (B, fam.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), fam.prefill_j, atol=1e-4)


def test_serve_step_greedy_stream_equals_jax(fam):
    step = make_serve_step(fam.model)
    cache = fam.cache(16)
    tok = fam.tbatch["tokens"][:, 0]
    out = []
    with torch.no_grad():
        for _ in range(12):
            tok, cache = step(fam.params, cache, tok)
            assert tok.dtype == torch.int32
            out.append(tok)
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), fam.stream_j)


def _tree_signature(leaves):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_equals_the_reference(arch, dtype):
    over = _overrides(arch)
    jcfg = jax_get_config(arch).reduced(dtype=dtype, **over)
    cfg = get_config(arch).reduced(dtype=dtype, **over)
    want = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    got = build_model(cfg, device="cpu").init(0)
    flat_j, tree_j = jax.tree.flatten(want)
    flat_t, _ = tree_lib.flatten(got)
    assert _tree_signature(flat_t) == [
        (tuple(x.shape), str(x.dtype)) for x in flat_j]
    # the same nesting and names: the reference's leaves land in the
    # port's tree through the bridge, leaf for leaf
    bridged = params_from_numpy(jax.tree.unflatten(
        tree_j, [np.zeros(x.shape, np.float32) for x in flat_j]),
        device="cpu")
    assert tree_lib.flatten(bridged)[1] == tree_lib.flatten(got)[1]


def test_vlm_loss_scores_the_text_positions_only():
    fam = _family("internvl2-26b")
    with torch.no_grad():
        logits, _ = fam.model.forward(fam.params, fam.tbatch["tokens"],
                                      fam.tbatch["extra_embeds"])
        assert logits.shape[1] == fam.cfg.vision_tokens + SEQ[fam.cfg.name]
        text = logits[:, fam.cfg.vision_tokens:]
        want = torch.nn.functional.cross_entropy(
            text[:, :-1].reshape(-1, text.shape[-1]),
            fam.tbatch["tokens"][:, 1:].reshape(-1).long())
        got = fam.model.loss(fam.params, fam.tbatch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
