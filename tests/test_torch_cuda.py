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
from torch_parity import (compact_block, compact_cases, cuda, isi_smear,  # noqa: F401  (fixture)
                          to_int16)

from m17_sdr_tpu_torch import _build
from m17_sdr_tpu_torch.convert import state_to_numpy
from m17_sdr_tpu_torch.dsp import discriminator as td
from m17_sdr_tpu_torch.dsp import equalize as teq
from m17_sdr_tpu_torch.dsp.discriminator import RxFrontEndState, rx_front_end
from m17_sdr_tpu_torch.fec import viterbi as tv
from m17_sdr_tpu_torch.frame import receiver as tr
from m17_sdr_tpu_torch.pipeline import rx as trx
from m17_sdr_tpu_torch.pipeline.rx import RxSessionState

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)
S2 = 384
# the kernels of every receive path; K4 runs only with the equalizer on or auto
RX_KERNELS = (_build.VITERBI, _build.RECEIVER_SCAN, _build.FRONT_END, _build.COMPACT)
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
    """The main path on the kernels and on the plain versions, on 32 clean
    channels and 32 whose ISI arms the automatic equalizer mid-session:
    every output field and every state field equal."""
    fixture = np.tile(_fixture_iq(), (4, 1, 1))
    iq = torch.as_tensor(np.concatenate([fixture, isi_smear(fixture)])).to(cuda)
    b, _, t = iq.shape
    blocks = iq.reshape(b, 2, t // 1920, 1920).permute(0, 2, 1, 3).contiguous()
    for k in _build.KERNELS:
        k.launches = 0
    out_k, st_k = trx.rx_stream(blocks, RxSessionState.init(b, cuda), afc_enabled=True,
                                equalize="auto")
    assert all(k.launches > 0 for k in _build.KERNELS)
    assert _build.EQUALIZE.launches == t // 1920
    out_r, st_r = trx.rx_stream(blocks, RxSessionState.init(b, cuda), afc_enabled=True,
                                equalize="auto", use_kernel=False)
    for name in out_k._fields:
        assert torch.equal(getattr(out_k, name), getattr(out_r, name)), name
    assert int(out_k.stream_gate[:32].sum()) == 32 * 8
    assert not st_k.eq_armed[:32].any() and st_k.eq_armed[32:].all()
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
    fe = RxFrontEndState.init(4, cuda)
    inf = torch.zeros(4, dtype=torch.bool, device=cuda)
    iq = torch.zeros(4, 2, 1920, dtype=torch.int16, device=cuda)
    for bad_iq, bad_st in ((iq.double(), fe), (iq[:, 0], fe), (iq[..., :1918], fe),
                           (iq[..., :0], fe), (iq[:, :1], fe),
                           (iq, fe._replace(disc_tail=fe.disc_tail[..., :1])),
                           (iq, fe._replace(rssi=fe.rssi[:3])),
                           (iq, fe._replace(dc_seeded=fe.dc_seeded.float())),
                           (iq, fe._replace(agc_gain=fe.agc_gain.cpu()))):
        with pytest.raises(ValueError):
            td.rx_front_end_cuda(bad_iq, bad_st, inf)
    with pytest.raises(ValueError):
        td.rx_front_end_cuda(iq, fe, inf[:3])


@pytest.mark.parametrize("n", [1, 15, 17, 12289])
@pytest.mark.parametrize("steps", [244, 148, 210, 205, 201])
def test_viterbi_kernel_ragged_batches(cuda, steps, n):   # noqa: F811
    """Trellis counts that leave the last block of 16 part empty, down to
    one trellis, with erasures: bits and metric equal.  T=201 is the
    self-test's length (tools/cuda_selftest.py), on no main path."""
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
    assert all(k.launches > n for k, n in zip(RX_KERNELS, before))
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


def _fir_decimate_f64(x: np.ndarray, tail: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """The x8 decimating FIR in float64 numpy: y[m] = sum_k h[k] x[8m - k]."""
    xx = np.concatenate([tail, x], axis=-1).astype(np.float64)
    m, n = x.shape[-1] // 8, len(taps)
    return sum(float(taps[n - 1 - j]) * xx[..., j: j + 8 * (m - 1) + 1: 8] for j in range(n))


def test_decimator_on_the_card_matches_float64(cuda):   # noqa: F811
    """fir_decimate on the card against float64 at one Pluto block:
    within 1e-5 of the output's peak (31 float32 products summed)."""
    from m17_sdr_tpu_torch.dsp import resample

    rng = np.random.default_rng(8)
    x = (0.5 * rng.normal(size=(64, 2, 15360))).astype(np.float32)
    tail = (0.5 * rng.normal(size=(64, 2, 30))).astype(np.float32)
    y, new_tail = resample.fir_decimate(torch.as_tensor(x).to(cuda), resample.pluto_dec_taps(),
                                        torch.as_tensor(tail).to(cuda))
    ref = _fir_decimate_f64(x, tail, resample.pluto_dec_taps())
    assert y.shape == (64, 2, 1920)
    assert np.abs(y.cpu().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert torch.equal(new_tail.cpu(), torch.as_tensor(x[..., -30:]))


def test_streaming_rx_kernel_path_matches_plain(cuda):   # noqa: F811
    """StreamingRx at B=64 (the fixture sessions tiled, host int16 wire
    blocks through the ring and the pinned uploads, 5-block chunks) on
    the kernels and on the plain versions, and rx_stream of the same
    blocks: every output field and every state field equal."""
    from m17_sdr_tpu_torch.app.streaming import StreamingRx

    wire = np.tile(_fixture_iq(), (8, 1, 1)).transpose(0, 2, 1)        # [64, T, 2]
    nblk = wire.shape[1] // 1920
    blocks = [np.ascontiguousarray(wire[:, i * 1920:(i + 1) * 1920]) for i in range(nblk)]
    res = {}
    for leg, use_kernel in (("kernel", None), ("plain", False)):
        before = [k.launches for k in _build.KERNELS]
        srx = StreamingRx(batch=64, afc=True, equalize="auto", chunk_blocks=5, device=cuda,
                          use_kernel=use_kernel)
        srx.run(iter(blocks))
        res[leg] = srx.finish()
        launched = [k.launches > n for k, n in zip(_build.KERNELS, before)]
        assert all(launched) if use_kernel is None else not any(launched)
    (out_k, st_k, n_k), (out_r, st_r, n_r) = res["kernel"], res["plain"]
    assert n_k == n_r == nblk
    iq = torch.as_tensor(np.stack(blocks, axis=1)).to(cuda).transpose(-1, -2)
    out_s, st_s = trx.rx_stream(iq, RxSessionState.init(64, cuda), afc_enabled=True,
                                equalize="auto")
    for name in out_k._fields:
        np.testing.assert_array_equal(getattr(out_k, name), getattr(out_r, name), err_msg=name)
        np.testing.assert_array_equal(getattr(out_k, name), getattr(out_s, name).cpu().numpy(),
                                      err_msg=name)
    assert int(out_k.stream_gate.sum()) == 64 * 8
    flat_k, flat_r, flat_s = (state_to_numpy(st) for st in (st_k, st_r, st_s))
    for k, v in flat_s.items():
        np.testing.assert_array_equal(flat_k[k], v, err_msg=k)
        np.testing.assert_array_equal(flat_r[k], v, err_msg=k)


def test_selftest_and_validation_gate_pass_on_the_card(cuda, capsys):   # noqa: F811
    """The self-test (both decoders on the card) and the acceptance gate at
    B=64 (its kernel leg on the card): both pass, and the gate's kernel leg
    launches both kernels."""
    import json

    from m17_sdr_tpu_torch.tools import cuda_selftest, kernel_validate

    before = _build.VITERBI.launches
    assert cuda_selftest.main([]) == 0
    assert _build.VITERBI.launches == before + 12
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (doc["platform"], doc["bit_mismatches"]) == ("cuda", 0)
    before = [k.launches for k in _build.KERNELS]
    assert kernel_validate.main(["--batch", "64"]) == 0
    assert all(k.launches > n for k, n in zip(RX_KERNELS, before))
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["kernel"] == doc["plain"] == {"frames": 512, "byte_errors": 0}


def _front_end_case(cuda, b: int, t: int, int16: bool, seed: int):
    """[b, 2, t] IQ of a tone in noise at levels from silence to past the
    AGC's upper threshold (both AGC steps, the limiter's floor), and a
    front-end state with a random tail, NCO, AFC estimate, meter and DC,
    and dc_seeded both ways."""
    rng = np.random.default_rng(seed)
    amp = np.linspace(0.0, 1.3, b)[:, None] if b > 1 else np.array([[0.6]])
    n = np.arange(t)
    ph = 2 * np.pi * rng.uniform(-0.02, 0.02, (b, 1)) * n + rng.uniform(0, 6.3, (b, 1))
    x = np.stack([np.cos(ph), np.sin(ph)], axis=1) * amp[:, None]
    x = x + 0.05 * rng.normal(size=x.shape)
    if b > 2:
        x[0] = 0.0                            # silence: the limiter's floor
    if int16:
        x = np.clip(np.round(x / 3.0e-5), -32768, 32767).astype(np.int16)
    iq = torch.as_tensor(x.astype(np.int16 if int16 else np.float32)).to(cuda)
    tail = rng.normal(size=(b, 2, 2))
    tail /= np.linalg.norm(tail, axis=1, keepdims=True)
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32)).to(cuda)   # noqa: E731
    st = RxFrontEndState(
        disc_tail=f32(tail), nco_phase=f32(rng.uniform(0, 6.3, b)),
        afc_delta=f32(rng.uniform(-0.01, 0.01, b)),
        rssi=f32(np.where(rng.random(b) < 0.3, 0.0, rng.uniform(0.0, 1.2, b))),
        agc_gain=f32(np.exp2(rng.uniform(-6, 6, b))), dc_est=f32(rng.normal(0, 0.01, b)),
        dc_seeded=torch.as_tensor(rng.random(b) < 0.5).to(cuda))
    return iq, st


def _in_frame(mode: str, b: int, blk: int, cuda):
    if mode == "toggling":
        return (torch.arange(b, device=cuda) + blk) % 2 == 0
    return torch.full((b,), mode == "always", dtype=torch.bool, device=cuda)


def _assert_front_end_equal(got, want, what):
    (dec_k, off_k, st_k), (dec_r, off_r, st_r) = got, want
    assert dec_k.shape == dec_r.shape and dec_k.is_contiguous(), what
    assert torch.equal(dec_k, dec_r), ("dec", what)
    assert torch.equal(off_k, off_r), ("offset", what)
    for f in RxFrontEndState._fields:
        assert torch.equal(getattr(st_k, f), getattr(st_r, f)), (f, what)


@pytest.mark.parametrize("afc", [False, True])
@pytest.mark.parametrize("int16", [True, False])
@pytest.mark.parametrize("t", [5, 1920, 24960])
@pytest.mark.parametrize("b", [1, 3, 64])
def test_front_end_kernel_matches_plain(cuda, b, t, int16, afc):   # noqa: F811
    """K3 against the plain front end over two chained blocks, with the
    in_frame gate never, always and toggling: dec, offset and every state
    field equal; one launch a call."""
    iq, st0 = _front_end_case(cuda, b, t, int16, seed=b * 7 + t)
    for mode in ("never", "always", "toggling"):
        st_k = st_r = st0
        for blk in range(2):
            inf = _in_frame(mode, b, blk, cuda)
            before = _build.FRONT_END.launches
            got = rx_front_end(iq, st_k, inf, afc_enabled=afc)
            assert _build.FRONT_END.launches == before + 1
            want = rx_front_end(iq, st_r, inf, afc_enabled=afc, use_kernel=False)
            torch.cuda.synchronize()
            _assert_front_end_equal(got, want, (mode, blk))
            st_k, st_r = got[2], want[2]


@pytest.mark.parametrize("int16", [True, False])
def test_front_end_kernel_reads_strided_input(cuda, int16):   # noqa: F811
    """Blocks taken as views: ``rx_stream``'s ``iq_blocks[:, i]``, a slice
    starting 3 samples into a row (not 16-byte aligned) and interleaved
    [B, T, 2] wire samples moved to [B, 2, T] (sample stride 2): K3 equals
    the plain version on each, and leaves its input state as it was."""
    iq, st = _front_end_case(cuda, 33, 4 * 1920 + 5, int16, seed=5)
    blocks = iq[..., :4 * 1920].reshape(33, 2, 4, 1920).permute(0, 2, 1, 3).contiguous()
    kept = [x.clone() for x in st]
    views = [blocks[:, i] for i in range(4)] + [iq[..., 3:3 + 1920 * 2],
                                                iq.transpose(1, 2).contiguous().transpose(1, 2)]
    for i, x in enumerate(views):
        inf = _in_frame("toggling", 33, i, cuda)
        got = rx_front_end(x, st, inf, afc_enabled=True)
        want = rx_front_end(x, st, inf, afc_enabled=True, use_kernel=False)
        _assert_front_end_equal(got, want, i)
    assert views[-1].stride(-1) == 2 and views[-2].storage_offset() == 3
    for a, k in zip(st, kept):
        assert torch.equal(a, k)


def test_front_end_kernel_long_rows(cuda):   # noqa: F811
    """Channels enough to fill the card, with rows longer than a thread
    block takes (T = 61440: each row split over blocks, the raw row
    through dec), and the main path's shape [4096, 2, 24960] (one block a
    row, the raw row in shared memory): equal to the plain version."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, t, blocks in ((600, 61440, 2), (4096, 24960, 1)):
        assert td.front_end_split(b, t, sms)[1] == blocks
        iq, st = _front_end_case(cuda, b, t, True, seed=b)
        inf = _in_frame("toggling", b, 0, cuda)
        got = rx_front_end(iq, st, inf)
        want = rx_front_end(iq, st, inf, use_kernel=False)
        _assert_front_end_equal(got, want, (b, t))


def _equalize_case(cuda, b: int, f: int, armed_mode: str, seed: int):
    """Frames [b, f, 192] of 4FSK symbols (sync words +-1, payload +-1/3,
    +-1, noise), every third channel through a two-ray ISI channel that
    closes its eye, a fifth of the slots without signal, a random 70 % of
    them parsed; taps near the identity; eye estimates from 0 to 0.3; the
    carried armed flag never, always, or alternating between channels, so
    that some arm and some disarm within the call."""
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, -1 / 3, 1 / 3, 1.0], size=(b, f, 192))
    sym[..., :8] = np.array([1, 1, 1, 1, -1, -1, 1, -1])
    isi = np.where(np.arange(b) % 3 == 1, 0.55, 0.05)[:, None, None]
    fr = sym + isi * np.roll(sym, 1, -1) + 0.3 * isi * np.roll(sym, 2, -1)
    fr = fr + rng.normal(0, 0.03, fr.shape)
    fr[rng.random((b, f)) < 0.2] *= 0.01
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32)).to(cuda)   # noqa: E731
    armed = {"never": np.zeros(b, bool), "always": np.ones(b, bool),
             "toggling": np.arange(b) % 2 == 0}[armed_mode]
    eye = rng.uniform(0.0, 0.3, b)
    eye[::4] = 0.0
    c = np.eye(5)[2] + rng.normal(0, 0.05, (b, 5))
    return (f32(fr), torch.as_tensor(rng.random((b, f)) < 0.7).to(cuda), f32(c), f32(eye),
            torch.as_tensor(armed).to(cuda))


def _assert_bits_equal(got, want, what):
    """Float outputs equal bit for bit (NaN where NaN), the rest equal."""
    for name, g, w in zip(("frames", "taps", "eye_est", "armed"), got, want):
        assert g.shape == w.shape and g.is_contiguous(), (name, what)
        if g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (name, what)
        else:
            assert torch.equal(g, w), (name, what)


@pytest.mark.parametrize("armed", ["never", "always", "toggling"])
@pytest.mark.parametrize("auto", [True, False])
@pytest.mark.parametrize("f", [1, 3, 15])
@pytest.mark.parametrize("b", [1, 3, 64])
def test_equalize_kernel_matches_plain(cuda, b, f, auto, armed):   # noqa: F811
    """K4 against the plain stage over two chained calls: frames, taps,
    eye estimate and armed flag equal bit for bit; one launch a call; the
    inputs left as they were."""
    fr, valid, c, eye, arm = _equalize_case(cuda, b, f, armed, seed=b * 31 + f)
    kept = [x.clone() for x in (fr, valid, c, eye, arm)]
    st_k = st_r = (c, eye, arm)
    for call in range(2):
        before = _build.EQUALIZE.launches
        got = teq.equalize_stage(fr, valid, *st_k, auto=auto)
        assert _build.EQUALIZE.launches == before + 1
        want = teq.equalize_stage(fr, valid, *st_r, auto=auto, use_kernel=False)
        torch.cuda.synchronize()
        _assert_bits_equal(got, want, call)
        st_k, st_r = got[1:], want[1:]
    for a, k in zip((fr, valid, c, eye, arm), kept):
        assert torch.equal(a, k)
    if auto and armed == "toggling" and b == 64:
        flips = got[3] != arm
        assert (flips & arm).any() and (flips & ~arm).any()       # some disarm, some arm
    if not auto:
        assert torch.equal(got[2], eye) and torch.equal(got[3], arm)


def test_equalize_kernel_guards_non_finite_taps(cuda):   # noqa: F811
    """A NaN symbol in a parsed frame: the solve gives no finite taps, the
    guard keeps the old ones, and K4 equals the plain stage, NaN for NaN."""
    fr, valid, c, eye, arm = _equalize_case(cuda, 5, 6, "always", seed=9)
    fr[1, 2, 17] = float("nan")
    valid[1, 2] = True
    for auto in (True, False):
        got = teq.equalize_stage(fr, valid, c, eye, arm, auto=auto)
        want = teq.equalize_stage(fr, valid, c, eye, arm, auto=auto, use_kernel=False)
        _assert_bits_equal(got, want, auto)
        assert torch.isnan(got[0][1, 2]).any() and torch.isfinite(got[1]).all()


def test_rx_block_runs_the_equalizer_as_one_launch(cuda):   # noqa: F811
    """A whole-session rx_block call with the equalizer on or automatic:
    exactly one K4 launch, none with it off."""
    iq = torch.as_tensor(isi_smear(_fixture_iq())).to(cuda)
    for equalize, launches in ((False, 0), ("on", 1), (True, 1), ("auto", 1)):
        before = _build.EQUALIZE.launches
        trx.rx_block(iq, RxSessionState.init(iq.shape[0], cuda), equalize=equalize)
        assert _build.EQUALIZE.launches == before + launches, equalize


def _assert_compact_equal(cuda, slot, flags, hist, what):
    """K5 against compact_ref on the same scan outputs: every output equal,
    floats bit for bit, one launch, the inputs left as they were; returns
    K5's outputs."""
    b = flags.shape[0]
    state = tr.ReceiverState.init(b, cuda)._replace(sym_hist=hist)
    kept = [x.clone() for x in (slot, flags, hist)]
    before = _build.COMPACT.launches
    ev_k, st_k = tr.compact_cuda(slot, flags, state)
    assert _build.COMPACT.launches == before + 1
    ev_r, st_r = tr.compact_ref(slot, flags, state)
    torch.cuda.synchronize()
    got = (*ev_k, st_k.sym_hist)
    want = (*ev_r, st_r.sym_hist)
    for name, g, w in zip((*tr.BlockEvents._fields, "sym_hist"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous(), (name, what)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (name, what)
    for a, k in zip((slot, flags, hist), kept):
        assert torch.equal(a.view(torch.int32), k.view(torch.int32))
    return ev_k, st_k


@pytest.mark.parametrize("case", sorted(compact_cases()))
def test_compact_kernel_edge_cases(cuda, case):   # noqa: F811
    """The hand-made blocks that pin compact_ref (tests/test_torch_compact.py):
    K5 equals it bit for bit."""
    s2, channels, _ = compact_cases()[case]
    _assert_compact_equal(cuda, *(x.to(cuda) for x in compact_block(s2, channels)), case)


def _random_scan_outputs(cuda, b: int, s2: int, p_valid: float, p_done: float, seed: int):
    """Flags of random bits with valid and completion bits drawn at the
    given rates, normal slot values with some NaN payloads, a random
    history."""
    rng = np.random.default_rng(seed)
    flags = rng.integers(-2**31, 2**31, size=(b, s2), dtype=np.int64).astype(np.int32)
    flags &= ~np.int32(tr.F_VALID | tr.F_DONE)
    flags |= (rng.random((b, s2)) < p_valid) * tr.F_VALID
    flags |= (rng.random((b, s2)) < p_done) * tr.F_DONE
    slot = rng.normal(size=(b, s2)).astype(np.float32)
    slot.view(np.int32)[rng.random((b, s2)) < 0.01] = 0x7fc00123
    hist = rng.normal(size=(b, 191)).astype(np.float32)
    return tuple(torch.as_tensor(x).to(cuda) for x in (slot, flags, hist))


# S2 385 takes the kernel's 4-byte loads, 16000 its global scratch
@pytest.mark.parametrize("s2", [384, 385, 4992, 16000])
@pytest.mark.parametrize("b", [1, 3, 64, 4096])
def test_compact_kernel_random_flags(cuda, b, s2):   # noqa: F811
    """Random flags at three rates of valid steps and completions (half of
    all steps; a frame's worth; none valid), chained over two calls so the
    second reads the first's history: K5 equals compact_ref."""
    for i, (pv, pd) in enumerate(((0.5, 0.5), (0.9, 0.0026), (0.0, 0.01))):
        slot, flags, hist = _random_scan_outputs(cuda, b, s2, pv, pd, seed=b * s2 + i)
        _, st = _assert_compact_equal(cuda, slot, flags, hist, (pv, pd))
        _assert_compact_equal(cuda, slot.flip(1).contiguous(), flags, st.sym_hist, (pv, pd, 2))


def test_compact_kernel_reads_unaligned_rows(cuda):   # noqa: F811
    """Contiguous rows one element into their storage (no 16-byte loads)
    and a strided history: K5 equals compact_ref."""
    slot, flags, hist = _random_scan_outputs(cuda, 5, 4992, 0.5, 0.003, seed=11)
    buf_s = torch.empty(slot.numel() + 1, device=cuda)
    buf_f = torch.empty(flags.numel() + 1, dtype=torch.int32, device=cuda)
    buf_s[1:] = slot.reshape(-1)
    buf_f[1:] = flags.reshape(-1)
    wide = torch.zeros(5, 400, device=cuda)
    wide[:, :382:2] = hist
    _assert_compact_equal(cuda, buf_s[1:].view(5, 4992), buf_f[1:].view(5, 4992),
                          wide[:, :382:2], "unaligned")


@pytest.mark.parametrize("mix", ["voice", "noise"])
def test_compact_kernel_on_the_scan_output(cuda, mix):   # noqa: F811
    """The fixture sessions (voice) and int16 noise, 64 channels staggered,
    through the front end and K2 as whole 13-block sessions, two calls
    chained: K5 equals compact_ref on K2's real slot values and flags."""
    iq = np.tile(_fixture_iq(), (8, 1, 1))
    if mix == "noise":
        iq = to_int16(np.random.default_rng(4).normal(0, 0.7071, iq.shape))
    iq = torch.as_tensor(np.stack([np.roll(x, 1920 * (c % 13), axis=-1)
                                   for c, x in enumerate(iq)])).to(cuda)
    fe = RxFrontEndState.init(iq.shape[0], cuda)
    st = tr.ReceiverState.init(iq.shape[0], cuda)
    frames = 0
    for _ in range(2):
        soft, _, fe = rx_front_end(iq, fe, st.flock)
        slot, flags, st2 = tr.receiver_scan_cuda(soft, st)
        ev, st = _assert_compact_equal(cuda, slot, flags, st2.sym_hist, mix)
        st = st2._replace(sym_hist=st.sym_hist)
        frames += int(ev.frame_valid.sum())
    assert (frames > 0) == (mix == "voice")


def test_rx_block_runs_the_compaction_as_one_launch(cuda):   # noqa: F811
    """A whole-session rx_block call launches K5 once and no sort: the
    profiler sees no aten::sort or aten::argsort."""
    iq = torch.as_tensor(_fixture_iq()).to(cuda)
    st = RxSessionState.init(iq.shape[0], cuda)
    trx.rx_block(iq, st)
    torch.cuda.synchronize()
    before = _build.COMPACT.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trx.rx_block(iq, st)
        torch.cuda.synchronize()
    assert _build.COMPACT.launches == before + 1
    names = {e.key for e in prof.key_averages()}
    assert "aten::sort" not in names and "aten::argsort" not in names, sorted(names)


def test_compact_wrapper_checks_inputs(cuda):   # noqa: F811
    slot, flags, hist = (x.to(cuda) for x in compact_block(16, [{}, {}]))
    st = tr.ReceiverState.init(2, cuda)._replace(sym_hist=hist)
    for bad in ((slot.double(), flags, st), (slot, flags.long(), st),
                (slot, flags.float(), st), (slot.cpu(), flags, st), (slot, flags.cpu(), st),
                (slot[:, :15], flags, st), (slot[:1], flags, st), (slot[0], flags, st),
                (slot, flags, st._replace(sym_hist=hist[:, :190])),
                (slot, flags, st._replace(sym_hist=hist.cpu())),
                (slot, flags, st._replace(sym_hist=hist.double())),
                (slot[:, :0], flags[:, :0], st)):
        with pytest.raises(ValueError):
            tr.compact_cuda(*bad)
