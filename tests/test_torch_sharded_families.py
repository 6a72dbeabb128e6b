"""RWKV6, Zamba2 and Whisper on a mesh of gloo ranks against the JAX
package's one-device steps, float32 on the CPU.

Each family reduced (``.reduced(dtype="float32")``, 2 layers: one group
of two mamba layers for zamba2), with params from JAX's
``init(PRNGKey(0))``, every leaf perturbed (as
``tests/test_torch_family_models.py`` does, so that ``u``, the decays,
``A_log``, ``D``, ``dt_bias`` and the biases count) and bridged.  The
widths put every cut of the rules that does not follow a Megatron pair on
the path:

* rwkv6 (H 4 of width 16): ``u`` (H, N) split on N, the channel mix's
  ``wv`` (a _COL name) on its output D behind ``wk`` split on F, the
  decay LoRA split on its rank;
* rwkv6 at d_model 48 (3 heads on 2 model ranks): the time mix the rules
  cut on D but not on whole heads, run whole with the split leaves
  gathered;
* zamba2: ``in_proj`` (296 columns: z 128, xBC 160, dt 8) cut
  contiguously through xBC, the conv split on its 160 channels, the SSD's
  8 heads, the shared attention's 4 heads and its K/V sequence-sharded;
* zamba2 at d_model 40 (5 SSD heads on 2 model ranks): ``out_proj`` and
  the conv split but not on whole heads, the mamba layers run whole with
  their split leaves (and the conv state) gathered;
* whisper at vocabulary 251 (as whisper-tiny's 51865, no even axis
  divides it): the embedding and the head left whole, the GELU MLP split
  with ``b_in`` sliced, q/k/v biases whole beside split projections, the
  16 frames' cross K/V sequence-sharded.

One spawn a mesh shape runs every family there (``bench.sharded_steps.
many``).  On ``(1, 2)`` and ``(2, 2)``, 4-token prompts of a batch of 4
go in through ``jit_serve_step``, then 4 greedy steps: each step's logits
of the rank's batch shard, the prefill step's logits (``jit_prefill_step``)
and the final cache shard against JAX's ``make_prefill_step`` /
``decode_step`` at atol 1e-5, the streams identical.  On ``(2, 2)``, 2
AdamW steps of ``jit_train_step`` against ``jax.jit(make_train_step)`` at
``tests/test_torch_sharded_train.py``'s limits (loss rtol 1e-5, grad_norm
rtol 1e-4, shards atol 1e-5).  One leaf is held otherwise: whisper's
cross-attention key bias ``bk``, whose exact gradient is 0 (it adds
``q . bk`` to every score of a query alike, and the softmax drops a
shift), so Adam's update of it is the sign of each side's rounding noise;
both sides' ``bk`` must stay within Adam's bound of ``sum_t lr_t`` of its
init.  So are the elements where the port's own one-device
``make_train_step`` parts from JAX's by more than 1e-5 (a gradient at
rounding level, near Adam's eps, where each run's rounding sets the
update: one element of zamba2's embedding; at most 0.1% of the elements
may be such).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine
from repro.serving.steps import make_prefill_step as j_prefill_step
from repro.training import train_step as jts
from repro_torch import tree as tree_lib
from repro_torch.bench import sharded_steps as ss
from repro_torch.bench import sharded_train as st
from repro_torch.distributed.sharding import map_with_path
from repro_torch.launch.mesh import run_ranks

CASES = {
    "rwkv6": ("rwkv6-1.6b", (("num_layers", 2),)),
    "rwkv6-whole": ("rwkv6-1.6b", (("num_layers", 2), ("d_model", 48),
                                   ("d_ff", 96))),
    "zamba2": ("zamba2-2.7b", (("num_layers", 2),)),
    "zamba2-whole": ("zamba2-2.7b", (("num_layers", 2), ("d_model", 40))),
    "whisper": ("whisper-tiny", (("num_layers", 2), ("vocab_size", 251))),
}
# the P + NEW - 1 written positions cross the model axis's shard boundary
# (MAX_SEQ / 2) at the prompt's last step
B, P, NEW, MAX_SEQ = 4, 4, 4, 8
TRAIN_B, TRAIN_S, STEPS = 8, 32, 2
LR = (1e-3, 2, 10)
ZERO_GRAD = "dec_layers/cross_attn/bk"


def _frames(cfg, rng, batch):
    if cfg.family != "audio":
        return None
    return rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)
                               ).astype(np.float32)


class Ref:
    """One case's JAX model, its perturbed params and its one-device
    serving and training outputs."""

    def __init__(self, name):
        arch, over = CASES[name]
        self.arch, self.over = arch, over
        cfg = jget_config(arch).reduced(dtype="float32", **dict(over))
        self.cfg = cfg
        model = jbuild_model(cfg, remat=False)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        params = jax.tree.map(lambda x: x + jnp.asarray(
            rng.standard_normal(x.shape) * 0.05, x.dtype), params)
        self.params = jax.tree.map(np.asarray, params)
        rng = np.random.default_rng(2)
        self.prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(
            np.int32)
        self.frames = _frames(cfg, rng, B)
        self.serve = self._serve(model, params)
        self.batches = tuple(self._batch(rng) for _ in range(STEPS))
        self.train = self._train(model, params)

    def _batch(self, rng):
        b = {"tokens": rng.integers(0, self.cfg.vocab_size,
                                    (TRAIN_B, TRAIN_S)).astype(np.int32)}
        f = _frames(self.cfg, rng, TRAIN_B)
        if f is not None:
            b["extra_embeds"] = f
        return b

    def _serve(self, model, params):
        batch = {"tokens": jnp.asarray(self.prompts)}
        if self.frames is not None:
            batch["extra_embeds"] = jnp.asarray(self.frames)
        prefill = np.asarray(jax.jit(j_prefill_step(model))(params, batch))
        cache = model.init_decode_cache(B, MAX_SEQ)
        if self.frames is not None:
            cache = model.prefill_cross(params, cache,
                                        batch["extra_embeds"])
        step = jax.jit(model.decode_step)
        logits, streams, nxt = [], [], None
        for t in range(P + NEW - 1):
            tok = jnp.asarray(self.prompts[:, t]) if t < P else nxt
            lg, cache = step(params, cache, tok)
            nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            logits.append(np.asarray(lg))
            if t >= P - 1:
                streams.append(np.asarray(nxt))
        return {"prefill": prefill, "logits": np.stack(logits),
                "streams": np.stack(streams, axis=1),
                "cache": jax.tree.map(np.asarray, cache)}

    def _train(self, model, params):
        opt = jadamw()
        state = jts.TrainState(params, opt.init(params),
                               jnp.zeros((), jnp.int32))
        step = jax.jit(jts.make_train_step(model, opt, jcosine(*LR)))
        metrics = []
        for b in self.batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics,
                "params": jax.tree.map(np.asarray, state.params)}

    def serve_spec(self):
        return ss.ServeSpec(self.arch, self.prompts, NEW, MAX_SEQ,
                            overrides=self.over, params=self.params,
                            frames=self.frames)

    def train_spec(self):
        return st.TrainSpec(self.arch, self.batches, overrides=self.over,
                            params=self.params, lr=LR)


@pytest.fixture(scope="module")
def refs():
    return {name: Ref(name) for name in CASES}


@pytest.fixture(scope="module")
def runs(refs):
    """Each mesh shape's ranks, one spawn each: ``{shape: [rank results:
    {"serve": {case: ...}, "train": {case: ...}}]}``."""
    out = {}
    for shape in [(1, 2), (2, 2)]:
        calls = [(ss.serve_job, (refs[n].serve_spec(), shape))
                 for n in CASES]
        if shape == (2, 2):
            calls += [(st.train_job, (refs[n].train_spec(), shape))
                      for n in CASES]
        ranks = run_ranks(ss.many, shape[0] * shape[1], (calls,),
                          timeout=600)
        out[shape] = [{"serve": dict(zip(CASES, r[:len(CASES)])),
                       "train": dict(zip(CASES, r[len(CASES):]))}
                      for r in ranks]
    return out


PARAMS = [(n, s) for n in CASES for s in [(1, 2), (2, 2)]]


def _rows(coords, shape):
    n = B // shape[0]
    return slice(coords["data"] * n, (coords["data"] + 1) * n)


@pytest.mark.parametrize("name,shape", PARAMS)
def test_prefill_step_matches_jax(refs, runs, name, shape):
    for r in runs[shape]:
        np.testing.assert_allclose(r["serve"][name]["prefill"],
                                   refs[name].serve["prefill"], atol=1e-5)


@pytest.mark.parametrize("name,shape", PARAMS)
def test_decode_logits_match_jax(refs, runs, name, shape):
    want = refs[name].serve["logits"]
    for r in runs[shape]:
        got = r["serve"][name]["logits"]
        np.testing.assert_allclose(
            got, want[:, _rows(r["serve"][name]["coords"], shape)],
            atol=1e-5)


@pytest.mark.parametrize("name,shape", PARAMS)
def test_greedy_streams_equal_jax(refs, runs, name, shape):
    for r in runs[shape]:
        np.testing.assert_array_equal(r["serve"][name]["streams"],
                                      refs[name].serve["streams"])


@pytest.mark.parametrize("name,shape", PARAMS)
def test_cache_shards_equal_jax_sliced(refs, runs, name, shape):
    ref = refs[name]
    _, model = ss.build(ref.serve_spec(), "cpu")
    for r in runs[shape]:
        got = r["serve"][name]
        want = ss.expected_cache_shard(model, ref.serve["cache"],
                                       got["coords"], shape)
        assert sorted(got["cache"]) == sorted(want)
        for k in want:
            assert got["cache"][k].shape == want[k].shape, k
            np.testing.assert_allclose(got["cache"][k], want[k], atol=1e-5,
                                       err_msg=k)
        if shape[1] > 1 and "k" in want:        # the sequence is split
            assert got["cache"]["k"].shape[2] == MAX_SEQ // shape[1]
            assert np.abs(got["cache"]["k"]).max() > 0   # owns written keys


def _paths(tree):
    out = []
    map_with_path(lambda p, leaf: out.append("/".join(p)), tree)
    return sorted(out)


@pytest.mark.parametrize("name", list(CASES))
def test_training_on_2x2_matches_jax(refs, runs, name):
    ref = refs[name]
    spec = ref.train_spec()
    _, model = st.build(spec, "cpu")
    one = st.train_job(spec, None)          # the port on one device
    lr_sum = sum(m["lr"] for m in ref.train["metrics"])
    noisy, total = 0, 0
    for r in runs[(2, 2)]:
        got = r["train"][name]
        for g, w in zip(got["metrics"], ref.train["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-4)
            np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        cut = functools.partial(st.expected_shard, model,
                                mesh_coords=got["coords"], mesh_shape=(2, 2))
        want, init, mine = (cut(full=t) for t in (ref.train["params"],
                                                  ref.params, one["shards"]))
        paths = _paths(got["shards"])
        assert paths == _paths(want)
        for path, a, b, a0, c in zip(
                paths, *(tree_lib.leaves(t) for t in (got["shards"], want,
                                                      init, mine))):
            assert a.shape == b.shape, path
            if path == ZERO_GRAD:
                for x in (a, b):
                    assert np.abs(x - a0).max() <= lr_sum * (1 + 1e-6), path
                continue
            # where the port's own one-device step parts from JAX's (a
            # gradient at rounding level, near Adam's eps), no float32 run
            # pins the update: each side within Adam's step bound
            far = np.abs(c - b) > 1e-5
            noisy += int(far.sum())
            total += far.size
            np.testing.assert_allclose(a[~far], b[~far], atol=1e-5,
                                       err_msg=path)
            for x in (a, b, c):
                assert np.abs(x - a0)[far].max(initial=0.0) <= lr_sum * (
                    1 + 1e-6), path
    assert noisy <= 1e-3 * total, (noisy, total)


def test_case_widths_put_the_quirks_on_the_path():
    """The cuts the module docstring names are the ones the rules make."""
    from repro_torch.config import get_config
    from repro_torch.layers import rwkv as rwkv_lib
    from repro_torch.layers import ssm as ssm_lib
    from repro_torch.models.api import build_model

    at = st.at_coords({"data": 0, "model": 0}, (2, 2))

    def tp_of(name):
        arch, over = CASES[name]
        cfg = get_config(arch).reduced(dtype="float32", **dict(over))
        return cfg, build_model(cfg, device="cpu").tensor_parallel(at)

    cfg, tp = tp_of("rwkv6")
    assert rwkv_lib.time_mix_aligned(tp, cfg.d_model, cfg.rwkv)
    assert tp.split("layers", "tm", "u") and tp.split("layers", "tm", "w1")
    assert tp._spec("layers", "tm", "u")[-1] == "model"      # N, not H
    assert tp._spec("layers", "cm", "wv")[-2:] == ("data", "model")
    cfg, tp = tp_of("rwkv6-whole")
    assert tp.split("layers", "tm", "wr")
    assert not rwkv_lib.time_mix_aligned(tp, cfg.d_model, cfg.rwkv)
    cfg, tp = tp_of("zamba2")
    dims = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm)
    assert ssm_lib.ssm_aligned(tp, cfg.d_model, cfg.ssm)
    half = (2 * dims.d_inner + 2 * cfg.ssm.d_state + dims.num_heads) // 2
    assert dims.d_inner < half < dims.d_inner + dims.conv_dim
    assert tp.split("mamba", "ssm", "in_proj")
    assert tp.split("mamba", "ssm", "conv_w")
    assert not tp.split("mamba", "ssm", "conv_b")
    cfg, tp = tp_of("zamba2-whole")
    assert not ssm_lib.ssm_aligned(tp, cfg.d_model, cfg.ssm)
    assert tp.split("mamba", "ssm", "conv_w")
    assert tp.split("mamba", "ssm", "out_proj")
    cfg, tp = tp_of("whisper")
    assert not tp.split("embed", "table") and not tp.split("head", "table")
    assert tp.split("dec_layers", "mlp", "w_in")
    assert not tp.split("dec_layers", "mlp", "b_in")
    assert tp.split("dec_layers", "cross_attn", "wq")
    assert not tp.split("dec_layers", "cross_attn", "bq")
    assert cfg.encoder_seq % 2 == 0


def test_halves_step_is_the_one_device_step(refs):
    # the control phase 49b reads a mesh against: the same function, its
    # gradients summed as two half-batches'
    spec = refs["rwkv6"].train_spec()
    whole = st.train_job(spec, None)
    halves = st.train_job(spec, None, halves=True)
    for a, b in zip(whole["metrics"], halves["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    for a, b in zip(tree_lib.leaves(whole["shards"]),
                    tree_lib.leaves(halves["shards"])):
        np.testing.assert_allclose(a, b, atol=1e-5)
