"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test is marked ``cuda`` and skips without a card.  The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_parity import cuda  # noqa: F401  (fixture)

from m17_sdr_tpu_torch import _build
from m17_sdr_tpu_torch.convert import state_to_numpy
from m17_sdr_tpu_torch.dsp.discriminator import RxFrontEndState, rx_front_end
from m17_sdr_tpu_torch.fec import viterbi as tv
from m17_sdr_tpu_torch.frame import receiver as tr
from m17_sdr_tpu_torch.pipeline import rx as trx
from m17_sdr_tpu_torch.pipeline.rx import RxSessionState

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)
S2 = 384
FIXTURE = _build.CSRC.parent / "data" / "rx_fixture.npz"


def _fixture_iq() -> np.ndarray:
    with np.load(FIXTURE) as z:
        return z["iq"]                                   # [8, 2, 24960] int16


@pytest.mark.parametrize("steps", [244, 148, 210, 205])
def test_viterbi_kernel_matches_ref(cuda, steps):   # noqa: F811
    rng = np.random.default_rng(steps)
    soft = rng.normal(size=(3, 700, 2 * steps)).astype(np.float32)
    soft[..., ::7] = 0.0
    x = torch.as_tensor(soft).to(cuda)
    before = _build.VITERBI.launches
    bits_k, met_k = tv.viterbi_decode(x)
    bits_r, met_r = tv.viterbi_decode_ref(x)
    torch.cuda.synchronize()
    assert _build.VITERBI.launches == before + 1
    assert bits_k.shape == (3, 700, steps) and met_k.shape == (3, 700)
    assert torch.equal(bits_k, bits_r)
    assert torch.equal(met_k, met_r)


def test_receiver_scan_kernel_matches_ref_under_drift(cuda):   # noqa: F811
    """The fixture sessions through the front end, then resampled at
    +130 ppm with 16 fractional delays, so that the locked timing loop
    slips inside frames: slots, flags and state equal block by block."""
    iq = torch.as_tensor(_fixture_iq()).to(cuda)
    b, _, t = iq.shape
    fe = RxFrontEndState.init(b, cuda)
    flock = torch.zeros(b, dtype=torch.bool, device=cuda)
    soft = []
    for i in range(t // 1920):
        s, _, fe = rx_front_end(iq[..., i * 1920:(i + 1) * 1920], fe, flock)
        soft.append(s)
    wave = torch.cat(soft, dim=1).cpu().numpy()
    n = wave.shape[1]
    tgrid = np.arange(int((n - 4) / (1 + 130e-6))) * (1 + 130e-6)
    wave = np.stack([np.interp(tgrid + k / 8, np.arange(n), w)
                     for k in range(16) for w in wave]).astype(np.float32)
    wave = torch.as_tensor(wave).to(cuda)
    st_k = st_r = tr.ReceiverState.init(wave.shape[0], cuda)
    window = st_k.window
    before = _build.RECEIVER_SCAN.launches
    nblk = wave.shape[1] // S2
    slips = frames = 0
    for blk in range(nblk):
        ext = torch.cat([window[:, 1:], wave[:, blk * S2:(blk + 1) * S2]], dim=1)
        window = ext[:, -31:]
        slot_k, flags_k, st_k = tr.receiver_scan_cuda(ext, st_k)
        slot_r, flags_r, st_r = tr.receiver_scan_ref(ext, st_r)
        assert torch.equal(slot_k, slot_r), blk
        assert torch.equal(flags_k, flags_r), blk
        for f in tr.ReceiverState._fields:
            assert torch.equal(getattr(st_k, f), getattr(st_r, f)), (f, blk)
        slips += int(((flags_k & tr.F_SLIPFRAME) != 0).sum())
        frames += int(((flags_k & tr.F_DONE) != 0).sum())
    assert _build.RECEIVER_SCAN.launches == before + nblk
    assert slips > 0 and frames > 0


def test_rx_stream_kernel_path_matches_plain(cuda):   # noqa: F811
    """The main path on the kernels and on the plain versions: every
    output field and every state field equal."""
    iq = torch.as_tensor(np.tile(_fixture_iq(), (8, 1, 1))).to(cuda)
    b, _, t = iq.shape
    blocks = iq.reshape(b, 2, t // 1920, 1920).permute(0, 2, 1, 3).contiguous()
    for k in _build.KERNELS:
        k.launches = 0
    out_k, st_k = trx.rx_stream(blocks, RxSessionState.init(b, cuda), afc_enabled=True,
                                equalize="auto")
    assert all(k.launches > 0 for k in _build.KERNELS)
    out_r, st_r = trx.rx_stream(blocks, RxSessionState.init(b, cuda), afc_enabled=True,
                                equalize="auto", use_kernel=False)
    for name in out_k._fields:
        assert torch.equal(getattr(out_k, name), getattr(out_r, name)), name
    assert int(out_k.stream_gate.sum()) == 64 * 8
    flat_k, flat_r = state_to_numpy(st_k), state_to_numpy(st_r)
    for k in flat_k:
        np.testing.assert_array_equal(flat_k[k], flat_r[k], err_msg=k)


def test_kernel_wrappers_check_inputs(cuda):   # noqa: F811
    with pytest.raises(ValueError):
        tv.viterbi_decode_cuda(torch.zeros(4, 296, dtype=torch.float64, device=cuda))
    st = tr.ReceiverState.init(4, cuda)
    with pytest.raises(ValueError):
        tr.receiver_scan_cuda(torch.zeros(S2 + 30, 4, device=cuda).t(), st)
    with pytest.raises(ValueError):
        tr.receiver_scan_cuda(torch.zeros(4, S2 + 30, device=cuda),
                              st._replace(clk=st.clk.to(torch.int64)))
