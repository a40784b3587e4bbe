"""Hymba trained by the port, on the CPU: one ``make_train_step`` step of
``hymba-1.5b`` ``smoke()`` against the reference's jitted step from the
same weights and tokens.  The port's Mamba recurrence runs through
``ops.ssm_scan``'s autograd ``Function`` (on the CPU its forward is
``ref.ssm_scan_with_checkpoints_ref``, its backward
``ref.ssm_scan_bwd_ref``); the reference differentiates its chunked
associative scan.

Tolerances, ``tests/_torch_lm.py``'s (the other families'): every metric
(loss, gradient norm, ...) rtol 1e-5; step 1's loss ``make_eval_step``'s
rtol 1e-6; gradients within 1e-4 of each leaf's max |g| and the stepped
parameters atol 1e-6 (the rule for near-zero gradients there).
"""
import pytest
torch = pytest.importorskip("torch", exc_type=ImportError)

import _torch_lm as lm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401

ARCH = "hymba-1.5b"
SEQ = 40          # 8 meta tokens ahead of them: 48 positions, two spans


@pytest.fixture(scope="module")
def hymba():
    m = lm.reference_train(ARCH, seq=SEQ)
    ops.reset_launch_counts()
    m["stepped"] = lm.port_train_step(m)
    return m


def test_train_step_metrics_match_reference(hymba):
    lm.check_train_metrics(hymba, hymba["stepped"])


def test_train_step_gradients_and_parameters_match_reference(hymba):
    lm.check_train_gradients(hymba, hymba["stepped"])


def test_the_step_trained_every_mamba_head(hymba):
    """Every layer's Mamba parameters moved, A's among them: their
    gradients reach them only through the scan's backward."""
    (_, mom, _) = hymba["stepped"]["got"]
    for name in ("a_log", "w_b", "w_c", "w_dt", "dt_bias", "conv"):
        g = mom[("layers", "mamba", name)]
        assert g.shape[0] == hymba["cfg"].n_layers
        for layer in g:
            assert (layer != 0).any() and torch.isfinite(
                torch.from_numpy(layer)).all(), name
