"""The reference chain against the port's plain chain at a tiny size on the
CPU: the same bits, block by block, on the voice mix and on noise."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.signals import noise, voice
from portbench.ref.fec.viterbi import viterbi_decode_np
from portbench.ref.frame import receiver as ref_receiver
from portbench.ref.pipeline import rx as ref_rx

B = 8
CFG = {"channels": B, "block_samples": 1920, "input_rate": 48_000}
MIXES = {"voice": (voice, {"signal": "voice", "sessions": 4, "frames": 8}),
         "noise": (noise, {"signal": "noise", "sigma": 0.7071})}


def _blocks(kind: str, seed: int = 5):
    builder, mix = MIXES[kind]
    sig = builder.build(mix, CFG, seed, "cpu")                  # [B, P, 2, T]
    return [sig[:, i] for i in range(sig.shape[1])]


def _equal(a, b) -> list[str]:
    return [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


@pytest.mark.parametrize("equalize", [False, "auto"])
@pytest.mark.parametrize("kind", ["voice", "noise"])
def test_reference_equals_the_ports_plain_chain(kind, equalize):
    from m17_sdr_tpu_torch.pipeline import rx as port_rx
    blocks = _blocks(kind) * 2                     # two periods: every phase, carried
    sp = port_rx.RxSessionState.init(B, "cpu")
    sr = ref_rx.RxSessionState.init(B, "cpu")
    frames = 0
    for i, blk in enumerate(blocks):
        op, sp = port_rx.rx_block(blk, sp, equalize=equalize, use_kernel=False)
        orr, sr = ref_rx.rx_block(blk, sr, equalize=equalize)
        assert _equal(op, orr) == [], f"block {i}"
        frames += int(op.stream_valid.sum())
    for part in ("frontend", "receiver", "eq"):
        assert _equal(getattr(sp, part), getattr(sr, part)) == []
    if kind == "voice":
        assert frames > 0


def test_batched_blocks_equal_block_by_block():
    blocks = _blocks("voice")
    st = ref_rx.RxSessionState.init(B, "cpu")
    one = []
    for blk in blocks:
        o, st = ref_rx.rx_block(blk, st, equalize="auto")
        one.append(o)
    many, st2 = ref_rx.rx_blocks(blocks, ref_rx.RxSessionState.init(B, "cpu"),
                                 equalize="auto", decode_rows=50)
    assert all(_equal(a, b) == [] for a, b in zip(one, many))
    assert _equal(st.receiver, st2.receiver) == []


def test_viterbi_and_scan_equal_the_ports_plain_versions():
    from m17_sdr_tpu_torch.fec.viterbi import viterbi_decode_ref
    from m17_sdr_tpu_torch.frame import receiver as port_receiver
    rng = np.random.default_rng(1)
    soft = rng.normal(size=(40, 2 * 148)).astype(np.float32)
    soft[:, 11::12] = 0.0
    bits, metric = viterbi_decode_np(soft)
    pb, pm = viterbi_decode_ref(torch.from_numpy(soft))
    assert np.array_equal(bits, pb.numpy()) and np.array_equal(metric, pm.numpy())
    x = torch.from_numpy(rng.normal(size=(B, 384)).astype(np.float32))
    ref = ref_receiver.receiver_scan(x, ref_receiver.ReceiverState.init(B, "cpu"))
    port = port_receiver.receiver_scan_ref(x, port_receiver.ReceiverState.init(B, "cpu"))
    assert torch.equal(ref[0], port[0]) and torch.equal(ref[1], port[1])
    assert _equal(ref[2], port[2]) == []


def test_the_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path
    root = Path(ref_rx.__file__).resolve().parents[1]
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in ("m17_sdr_tpu_torch", "m17_sdr_tpu", "jax"), \
                        f"{path}: {n}"
