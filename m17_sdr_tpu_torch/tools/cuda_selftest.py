"""Hardware self-test of the Viterbi kernel against the plain decoder.

Port of the JAX package's ``tools/tpu_selftest.py``.  At each trellis
length T of TRELLIS_STEPS (the M17 lengths 244, 148, 210 and 201) it
decodes, on ROWS trellises each,

  (a) random soft bits: the kernel and the plain decoder must take the
      same path;
  (b) clean codewords of random bits: both must agree, and the kernel's
      first T-4 bits must be the encoded bits (it inverts the encoder);
  (c) the same codewords under Gaussian noise of sigma 0.5: both must agree.

The kernel is ``fec/viterbi.py::viterbi_decode`` on CUDA tensors (K1,
``csrc/viterbi.cu``); the reference is ``viterbi_decode_ref``, the plain
version, where the JAX tool compares with its XLA decoder.  The inputs are
the JAX tool's, value for value: ``default_rng(0)`` draws, for each T in
order, the soft bits, then the payload bits, then the noise.  Every
mismatch is summed on the device and one scalar crosses to the host.

    python -m m17_sdr_tpu_torch.tools.cuda_selftest [--device cuda|cpu]

``--device`` defaults to the card and exits 1 without one.  Under
``--device cpu`` both sides are the plain decoder, so the run checks the
draws and the encoder inversion only, and says so on stderr.  Prints one
JSON line {"platform", "checks", "bit_mismatches", "ok"}; exits 0 only on
a pass.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..fec.conv import conv_encode_bits
from ..fec.viterbi import viterbi_decode, viterbi_decode_ref

TRELLIS_STEPS = (244, 148, 210, 201)
ROWS = 128
SEED = 0
NOISE_SIGMA = 0.5


class Draw(NamedTuple):
    """One trellis length's inputs, as the JAX tool draws them."""

    steps: int
    soft: np.ndarray     # [ROWS, 2T] float32 random soft bits
    bits: np.ndarray     # [ROWS, T-4] uint8 payload bits
    noise: np.ndarray    # [ROWS, 2T] float32, sigma NOISE_SIGMA


def draws(seed: int = SEED) -> Iterator[Draw]:
    """The JAX tool's inputs for every T of TRELLIS_STEPS, in its order."""
    rng = np.random.default_rng(seed)
    for steps in TRELLIS_STEPS:
        soft = rng.normal(size=(ROWS, 2 * steps)).astype(np.float32)
        bits = rng.integers(0, 2, (ROWS, steps - 4), dtype=np.uint8)
        noise = rng.normal(0, NOISE_SIGMA, (ROWS, 2 * steps)).astype(np.float32)
        yield Draw(steps, soft, bits, noise)


def codewords(bits: torch.Tensor) -> torch.Tensor:
    """The encoded bits of ``bits`` [N, T-4] as clean soft bits [N, 2T]:
    +1.0 for a 1, -1.0 for a 0."""
    return torch.where(conv_encode_bits(bits) > 0, 1.0, -1.0).to(torch.float32)


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int64) - b.to(torch.int64)).abs().sum()


def selftest(device="cuda") -> tuple[list[str], torch.Tensor]:
    """(the check names, the summed bit mismatches as a 0-d tensor on
    ``device``).  Nothing is read back."""
    dev = torch.device(device)
    checks = []
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for d in draws():
        soft = torch.as_tensor(d.soft).to(dev)
        total += _mismatch(viterbi_decode(soft)[0], viterbi_decode_ref(soft)[0])
        checks.append(f"random_t{d.steps}")
        bits = torch.as_tensor(d.bits).to(dev)
        clean = codewords(bits)
        noisy = clean + torch.as_tensor(d.noise).to(dev)
        for soft2, tag in ((clean, "clean"), (noisy, "noisy")):
            got = viterbi_decode(soft2)[0]
            total += _mismatch(got, viterbi_decode_ref(soft2)[0])
            if tag == "clean":
                total += _mismatch(got[:, :bits.shape[1]], bits)
            checks.append(f"{tag}_t{d.steps}")
    return checks, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m m17_sdr_tpu_torch.tools.cuda_selftest",
                                 description="The Viterbi kernel against the plain decoder.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; run with --device cpu to use the CPU", file=sys.stderr)
        return 1
    if args.device == "cpu":
        print("note: on the CPU both sides are the plain decoder; this run checks the draws "
              "and that the decoder inverts the encoder, not the kernel", file=sys.stderr)
    checks, total = selftest(args.device)
    mism = int(total.item())           # the one transfer
    print(json.dumps({"platform": args.device, "checks": checks, "bit_mismatches": mism,
                      "ok": mism == 0}))
    return 0 if mism == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
