"""The port's entry points of the serving slice on the CPU: the
``--search-index`` mode of ``repro_torch.launch.serve``, and the two
examples (``repro_torch.examples.similarity_search`` and
``serve_with_index``) at a few hundred series.

``serve_with_index`` embeds with the port's Hymba stack; one embedding
of Hymba ``smoke()`` is held against the reference example's own
``embed`` on repro's weights (carried across with
``interop.params_from_arrays``) at 2e-3 absolute, the bar of
``tests/test_torch_models.py``'s Hymba logits.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import repro.core as jcore
from repro import storage as jst
from repro.configs import get_config as jget_config
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import random_walk
from repro_torch.examples import serve_with_index, similarity_search
from repro_torch.launch import serve
from _torch_parity import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def index_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("entry") / "rw.dsix"
    raw = random_walk(600, 64, seed=3)
    jst.save_index(jcore.build(jnp.asarray(raw), capacity=32), p)
    return p


def test_serve_search_index_mode(index_path, capsys):
    assert serve.main(["--search-index", str(index_path), "--device", "cpu",
                       "--tenants", "2", "--deadline-blocks", "2"]) == 0
    out = capsys.readouterr().out
    assert "2 tenants x 4 queries (top-5)" in out
    assert "anytime (deadline 2 blocks)" in out
    assert "certificate verified True" in out


def test_serve_search_index_needs_no_arch_and_defaults_to_the_card(
        index_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--search-index", str(index_path)])


def test_similarity_search_example(capsys):
    assert similarity_search.main(["--n-series", "400", "--device",
                                   "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("UCR-Suite-p", "ParIS", "MESSI (paper)",
                 "MESSI (block-major)", "top-5 ids", "anytime", "DTW 1-NN"):
        assert name in out


SMALL = ["--corpus", "300", "--queries", "8", "--seq", "16", "--batches",
         "2", "--device", "cpu"]


def test_serve_with_index_in_memory(capsys):
    assert serve_with_index.main(SMALL) == 0
    out = capsys.readouterr().out
    assert "building MESSI vector index ..." in out
    assert "exact self-retrieval@1" in out


def test_serve_with_index_out_of_core_and_concurrent(tmp_path, capsys):
    path = str(tmp_path / "corpus.dsix")
    assert serve_with_index.main(SMALL + ["--index-path", path]) == 0
    first = capsys.readouterr().out
    assert "published index" in first
    assert serve_with_index.main(SMALL + ["--index-path", path,
                                          "--concurrency", "3"]) == 0
    second = capsys.readouterr().out
    assert "opened" in second and "3 tenant threads" in second
    # the same last batch's quality lines: coalescing changes no answer
    pick = [ln for ln in first.splitlines() if "self-retrieval" in ln
            or "cosine" in ln]
    assert pick and all(ln in second for ln in pick)


def test_serve_with_index_names_the_missing_architectures(capsys):
    """The MoE, RWKV and Whisper families embed and serve too (their
    refusals went with ROADMAP.md items 18c and 18d)."""
    for arch in ("rwkv6-7b", "granite-moe-1b-a400m", "whisper-medium"):
        assert serve_with_index.main(
            ["--arch", arch, "--corpus", "64", "--queries", "4", "--seq",
             "8", "--batches", "1", "--device", "cpu"]) == 0
        assert "exact self-retrieval@1" in capsys.readouterr().out


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_with_index", ROOT / "examples" / "serve_with_index.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_embedding_matches_reference():
    ref = _reference_example()
    jcfg = jget_config("hymba-1.5b", smoke=True)
    cfg = get_config("hymba-1.5b", smoke=True)
    jparams = jcommon.build_params(JT.param_specs(jcfg),
                                   jax.random.PRNGKey(0))
    params = interop.params_from_arrays(
        jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (3, 16)).astype(np.int32)
    want = np.asarray(ref.embed(jparams, jcfg, jnp.asarray(toks)))
    got = serve_with_index.embed(params, cfg, torch.from_numpy(toks)
                                 .to(torch.int64)).numpy()
    assert got.shape == want.shape == (3, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
