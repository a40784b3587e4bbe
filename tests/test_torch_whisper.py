"""The port's Whisper encoder-decoder (``repro_torch.models.transformer``'s
enc_dec branches) and the ``whisper-medium`` ``smoke()`` model against
repro's, on the CPU.

``_sinusoid`` within 1e-6; the encoder and the decoder in its train,
prefill and decode modes within 2e-3 (the whole models' bar,
tests/_torch_lm.py), the caches' self and cross K/V included.  Frame
counts stay at most 1,024: the reference's decode cross-attention reads
only whole chunks of 1,024 frames (ROADMAP.md Queue 3), the port's every
frame, which a ragged count shows against a plain softmax.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch", exc_type=ImportError)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_lm as lm  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

ARCH = "whisper-medium"
PROMPT, GEN, FRAMES = 8, 8, 24


@pytest.mark.parametrize("n,d", [(24, 64), (1500, 1024), (448, 64)])
def test_sinusoid_matches_reference(n, d):
    np.testing.assert_allclose(T._sinusoid(n, d).numpy(),
                               np.asarray(JT._sinusoid(n, d)), rtol=0,
                               atol=1e-6)


def test_param_specs_match_reference():
    for smoke in (False, True):
        cfg, jcfg = get_config(ARCH, smoke=smoke), jget_config(ARCH,
                                                               smoke=smoke)
        leaf = lambda s: (tuple(s.shape), tuple(s.axes), s.init, s.scale,
                          s.value)
        got = common.tree_map(leaf, T.param_specs(cfg))
        want = jax.tree.map(leaf, JT.param_specs(jcfg),
                            is_leaf=lambda x: isinstance(x,
                                                         jcommon.ParamSpec))
        assert got == want
        assert {"enc_final_norm", "dec_pos", "dec", "lm_head"} <= set(got)


@pytest.fixture(scope="module")
def model():
    return lm.reference_run(ARCH, prompt=PROMPT, gen=GEN, frames=FRAMES)


@pytest.fixture(scope="module")
def stepped(model):
    return lm.port_train_step(model)


def _ctx(jcfg, mode):
    return JT.Ctx(jcfg, None, (), mode)


def test_encoder_and_decoder_stacks_match_reference(model):
    """``encoder_stack`` and ``whisper_decoder`` in train mode on their
    own, against the reference's."""
    cfg, p = model["cfg"], model["params"]
    jcfg = jget_config(ARCH, smoke=True)
    pj = jax.tree.map(jnp.asarray, model["pj"])
    b = model["full_batch"]
    want = JT.encoder_stack(pj, jnp.asarray(b["frames"]), jcfg,
                            _ctx(jcfg, "train"))
    with torch.no_grad():
        got = T.encoder_stack(p, torch.from_numpy(b["frames"]), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-3)
        toks = b["dec_tokens"]
        jx, _ = JT.whisper_decoder(pj, jnp.asarray(toks), want, jcfg,
                                   _ctx(jcfg, "train"))
        x, _ = T.whisper_decoder(p, torch.from_numpy(toks).long(), got, cfg,
                                 "train")
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=2e-3)


def test_forward_matches_reference(model):
    lm.check_forward(model)


def test_prefill_matches_reference(model):
    """The self K/V at [0, prompt) and the cross K/V over every frame."""
    lm.check_prefill(model)


def test_decode_matches_reference(model):
    lm.check_decode(model)


def test_train_step_metrics_match_reference(model, stepped):
    lm.check_train_metrics(model, stepped)


def test_train_step_gradients_and_parameters_match_reference(model,
                                                             stepped):
    """Whisper smoke()'s gradients are heavy-tailed: about 6.5% of the
    elements lie below 1e-3 of their leaf's max (at 24 and at 64 frames),
    so the share left out of the 1e-6 comparison is capped at 10%, not
    5%; those elements are still held within AdamW's 2 lr."""
    lm.check_train_gradients(model, stepped, left_out_cap=0.10)


def test_serving_is_consistent_with_forward(model):
    lm.check_serving_consistency(model)


def test_decode_reads_every_frame_of_a_ragged_cross_cache(model):
    """A decode step against 1,100 frames of cross K/V (random, written
    into the cache): attention over every frame does not depend on their
    order, so the port's logits stay the same when the frames are
    permuted across the 1,024 boundary; the reference's, which read only
    the first 1,024, do not."""
    cfg, p = model["cfg"], model["params"]
    rng = np.random.default_rng(4)
    cache = T.init_cache(cfg, 1, 1100, dtype=torch.float32, device="cpu")
    for name in ("xk", "xv"):
        cache[0][name].copy_(torch.from_numpy(rng.standard_normal(
            cache[0][name].shape).astype(np.float32)))
    perm = torch.from_numpy(rng.permutation(1100))
    moved = [{k: v[:, :, perm] if k in ("xk", "xv") else v.clone()
              for k, v in cache[0].items()}]
    jcaches = [jax.tree.map(jnp.asarray, interop.cache_to_arrays(c))
               for c in (cache, moved)]
    tok = np.array([[3]], np.int32)
    got = [T.decode_step(p, tok, 0, c, cfg, device="cpu")[0].numpy()
           for c in (cache, moved)]
    np.testing.assert_allclose(got[0], got[1], rtol=0, atol=1e-5)
    pj, jcfg = jax.tree.map(jnp.asarray, model["pj"]), jget_config(
        ARCH, smoke=True)
    want = [np.asarray(JT.decode_step(pj, jnp.asarray(tok), jnp.asarray(0),
                                      c, jcfg)[0]) for c in jcaches]
    assert np.abs(want[0] - want[1]).max() > 1e-3


def test_serving_refuses_a_prompt_past_decoder_len(model):
    cfg, p = model["cfg"], model["params"]
    with pytest.raises(ValueError, match="decoder_len"):
        serve.greedy_generate(p, cfg, np.zeros((1, 10), np.int64), 8,
                              frames=np.zeros((1, 4, cfg.d_model),
                                              np.float32), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        serve.greedy_generate(p, cfg, np.zeros((1, 4), np.int64), 2,
                              device="cpu")


def test_remat_changes_no_value(model):
    """Per-layer checkpointing of the encoder and decoder stacks
    recomputes the same values: the step's metrics and parameters
    bitwise."""
    outs = [lm.port_train_step(dict(model, cfg=dataclasses.replace(
        model["cfg"], remat=r))) for r in ("none", "full")]
    assert outs[0]["got"][2] == outs[1]["got"][2]
    for path, a in outs[0]["got"][0].items():
        assert np.array_equal(a, outs[1]["got"][0][path]), path


def test_params_and_cache_cross_name_for_name(model):
    cache = T.init_cache(model["cfg"], 2, FRAMES, dtype=torch.float32,
                         device="cpu")
    back = interop.cache_from_arrays(interop.cache_to_arrays(cache),
                                     device="cpu")
    assert set(back[0]) == {"k", "v", "xk", "xv"}
    assert back[0]["xk"].shape[2] == FRAMES
    assert back[0]["k"].shape[2] == model["cfg"].decoder_len
