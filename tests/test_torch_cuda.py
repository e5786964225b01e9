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
    before = _build.RECEIVER_SCAN.launches
    nblk = wave.shape[1] // S2
    slips = frames = 0
    for blk in range(nblk):
        samples = wave[:, blk * S2:(blk + 1) * S2].contiguous()
        slot_k, flags_k, st_k = tr.receiver_scan_cuda(samples, st_k)
        slot_r, flags_r, st_r = tr.receiver_scan_ref(samples, st_r)
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
        tr.receiver_scan_cuda(torch.zeros(4, S2, dtype=torch.float64, device=cuda), st)
    with pytest.raises(ValueError):
        tr.receiver_scan_cuda(torch.zeros(4, S2, device=cuda),
                              st._replace(clk=st.clk.to(torch.int64)))
    with pytest.raises(ValueError):
        tr.receiver_scan_cuda(torch.zeros(4, S2, device=cuda),
                              st._replace(window=st.window[:, 1:]))
    with pytest.raises(ValueError):
        tr.receiver_scan_cuda(torch.zeros(4, 0, device=cuda), st)


@pytest.mark.parametrize("n", [1, 15, 17, 12289])
@pytest.mark.parametrize("steps", [244, 148, 210, 205])
def test_viterbi_kernel_ragged_batches(cuda, steps, n):   # noqa: F811
    """Trellis counts that leave the last block of 16 part empty, down to
    one trellis, with erasures: bits and metric equal."""
    rng = np.random.default_rng(steps * 100003 + n)
    soft = rng.normal(size=(n, 2 * steps)).astype(np.float32)
    soft[:, 5::12] = 0.0
    soft[:, 11::12] = 0.0
    x = torch.as_tensor(soft).to(cuda)
    bits_k, met_k = tv.viterbi_decode_cuda(x)
    bits_r, met_r = tv.viterbi_decode_ref(x)
    torch.cuda.synchronize()
    assert bits_k.shape == (n, steps) and bits_k.is_contiguous()
    assert torch.equal(bits_k, bits_r)
    assert torch.equal(met_k, met_r)


_WARM = {}


def _warm_start(cuda, b: int):
    """A soft waveform [b, n] of the fixture sessions after the front end,
    channel c delayed by 37 c samples, and the plain scan's state after
    its first 768 samples (hunting, acquiring and locked channels; the
    window a strided view)."""
    if b not in _WARM:
        iq = torch.as_tensor(_fixture_iq()).to(cuda)
        fe = RxFrontEndState.init(iq.shape[0], cuda)
        flock = torch.zeros(iq.shape[0], dtype=torch.bool, device=cuda)
        soft = []
        for i in range(iq.shape[2] // 1920):
            s, _, fe = rx_front_end(iq[..., i * 1920:(i + 1) * 1920], fe, flock)
            soft.append(s)
        wave = torch.cat(soft, dim=1)                      # [8, 4992]
        idx = (torch.arange(wave.shape[1], device=cuda)[None, :]
               + 37 * torch.arange(b, device=cuda)[:, None]) % wave.shape[1]
        wave = torch.gather(wave[torch.arange(b, device=cuda) % wave.shape[0]], 1, idx)
        _, _, st = tr.receiver_scan_ref(wave[:, :768], tr.ReceiverState.init(b, cuda))
        _WARM[b] = (wave, st)
    return _WARM[b]


@pytest.mark.parametrize("s2", [2, 31, 97, 384, 777])
@pytest.mark.parametrize("b", [1, 33, 4096])
def test_receiver_scan_kernel_block_shapes(cuda, b, s2):   # noqa: F811
    """Channel counts that leave the last block of channels part empty,
    blocks shorter than the filter, odd, and longer than one staged chunk,
    chained over 3 blocks from a warmed state, the samples a strided view:
    slots, flags and every state field equal, the window included; the
    outputs contiguous [B, S2]."""
    wave, st = _warm_start(cuda, b)
    st_k = st_r = st
    for blk in range(3):
        samples = wave[:, 768 + blk * s2:768 + (blk + 1) * s2]
        slot_k, flags_k, st_k = tr.receiver_scan_cuda(samples, st_k)
        slot_r, flags_r, st_r = tr.receiver_scan_ref(samples, st_r)
        assert slot_k.shape == flags_k.shape == (b, s2)
        assert slot_k.is_contiguous() and flags_k.is_contiguous()
        assert torch.equal(slot_k, slot_r), blk
        assert torch.equal(flags_k, flags_r), blk
        assert torch.equal(st_k.window, st_r.window), blk
        for f in tr.ReceiverState._fields:
            assert torch.equal(getattr(st_k, f), getattr(st_r, f)), (f, blk)


def test_tx_on_the_card_matches_the_cpu(cuda):   # noqa: F811
    """The TX slice on the card against the same calls on the CPU: session
    dibits equal; IQ and phase to 6e-4, the bench mix within 20 LSB of
    3e-5.  The f32 phase reaches ~500 rad, where an ulp is 6.1e-5, and the
    card's cumsum adds in another order than the CPU's: up to 4 ulps
    apart on these sessions, 10 allowed."""
    from m17_sdr_tpu_torch.pipeline import benchdata
    from m17_sdr_tpu_torch.pipeline import tx as txp

    lsf, pay = benchdata.bench_sessions("cpu")
    data = torch.randint(0, 256, (64, 60), generator=torch.Generator().manual_seed(0),
                         dtype=torch.uint8)
    for name, build in (
            ("voice", lambda d: txp.build_voice_session_dibits(lsf.to(d), pay.to(d))),
            ("packet", lambda d: txp.build_packet_session_dibits(lsf.to(d), data.to(d))),
            ("bert", lambda d: txp.build_bert_session_dibits(64, 6, device=d))):
        dib_c, dib_g = build("cpu"), build(cuda)
        assert torch.equal(dib_g.cpu(), dib_c), name
        iq_c, st_c = txp.dibits_to_iq(dib_c)
        iq_g, st_g = txp.dibits_to_iq(dib_g)
        torch.testing.assert_close(iq_g.cpu(), iq_c, rtol=0, atol=6e-4)
        torch.testing.assert_close(st_g.phase.cpu(), st_c.phase, rtol=0, atol=6e-4)
    blk_c, nblk = benchdata.make_bench_blocks(128, device="cpu")
    blk_g, _ = benchdata.make_bench_blocks(128, device=cuda)
    diff = (torch.stack(blk_g, 1).cpu().to(torch.int32) - torch.stack(blk_c, 1).to(torch.int32))
    assert nblk == 13 and int(diff.abs().max()) <= 20


def test_loopbacks_kernel_path_match_plain(cuda):   # noqa: F811
    """BERT and packet loopbacks on the kernels and on the plain versions
    with the same noise: BER counts and reassembled packets equal."""
    from m17_sdr_tpu_torch.pipeline import loopback as lb
    from m17_sdr_tpu_torch.pipeline.benchdata import bench_sessions

    b = 33
    snr = torch.linspace(10.0, 30.0, b, device=cuda)
    noise = torch.randn((b, 2, 10 * 192 * 8), generator=torch.Generator(cuda).manual_seed(1),
                        device=cuda)
    before = [k.launches for k in _build.KERNELS]
    res_k = lb.bert_loopback(b, 4, snr_db=snr, noise=noise, device=cuda)
    assert all(k.launches > n for k, n in zip(_build.KERNELS, before))
    res_r = lb.bert_loopback(b, 4, snr_db=snr, noise=noise, device=cuda, use_kernel=False)
    for a, r in zip(res_k, res_r):
        assert torch.equal(a, r)
    assert int(res_k[1].sum()) > 0

    lsf = bench_sessions(cuda)[0][:1].expand(b, -1)
    data = torch.randint(0, 256, (b, 30), generator=torch.Generator(cuda).manual_seed(2),
                         device=cuda, dtype=torch.uint8)
    gen = [torch.Generator(cuda).manual_seed(3) for _ in range(2)]
    out_k, _ = lb.packet_loopback(lsf, data, snr_db=snr, generator=gen[0])
    out_r, _ = lb.packet_loopback(lsf, data, snr_db=snr, generator=gen[1], use_kernel=False)
    got = lb.reassemble_packets(out_k)
    assert got == lb.reassemble_packets(out_r)
    assert got[-1] == bytes(data[-1].cpu().tolist())
