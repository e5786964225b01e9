"""The port's whole receive path against the JAX package.

Every field of RxBlockOutput and of the session state over multi-block
sessions with two acquisitions: integer, bool and byte fields exactly,
float fields to the tolerance stated in torch_parity.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_outputs_match,
    assert_states_match,
    to_int16,
    two_sessions,
)

from m17_sdr_tpu.pipeline import rx as jrx
from m17_sdr_tpu_torch.pipeline import rx as trx

torch.set_num_threads(2)


@pytest.mark.parametrize("afc, equalize, int16", [
    (False, False, False), (True, False, False), (False, "on", False), (True, "auto", True)])
def test_rx_stream_matches_jax(afc, equalize, int16):
    x = to_int16(two_sessions()) if int16 else two_sessions()
    b = x.shape[0]
    out_t, st_t = trx.rx_stream(torch.as_tensor(x), trx.RxSessionState.init(b, "cpu"),
                                afc_enabled=afc, equalize=equalize)
    out_j, st_j = jrx.rx_stream(jnp.asarray(x), jrx.RxSessionState.init(b),
                                afc_enabled=afc, equalize=equalize)
    assert_outputs_match(out_t, out_j)
    assert_states_match(st_t, st_j)
    # both sessions were acquired and their LSFs decoded on every channel
    assert (np.asarray(out_j.aos).sum(axis=1) == 2).all()
    assert (np.asarray(out_j.lsf_valid).sum(axis=(1, 2)) == 2).all()
    assert np.asarray(out_j.stream_gate).sum() > 0
