#!/usr/bin/env python
"""Corrupted zstd frames through the port's decoder: none may crash it.

The decoder (``tcs_tpu_torch/csrc/zstd.c``) runs in the process that drives
the card, through ctypes, so a damaged checkpoint must raise
(``CorruptZstd``) or decode, never crash the process. This writes valid
frames with the ``zstandard`` module (levels 1 to 22, with and without
checksum and content size, payloads of float32 and bfloat16 noise, zeros,
repeated and text-like bytes, concatenated and skippable frames), corrupts
copies of them (bits flipped, bytes changed, cut, inserted or deleted) and
decodes each through ``tcs_tpu_torch.utils.zstd.decompress`` in this process,
with the capacity a reader would pass (the payload's size). Where
``zstandard`` rejects a corrupted frame the port must raise; where both
decode it they must agree. With ``--sanitize`` it also builds ``csrc/zstd.c``
with a small C harness under AddressSanitizer and UBSan (``cc
-fsanitize=address,undefined``) and runs the same frames through it, each
with a capacity of exactly its payload and with none, failing on any
report. Prints the counts of each outcome.

Usage: ``python scripts/zstd_fuzz.py [--frames 4000] [--seed 0] [--sanitize]``
(the CPU; it imports ``zstandard``).
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HARNESS = r"""
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
long tcs_zstd_decompress(const uint8_t *, long, uint8_t *, long, char *, int);
long long tcs_zstd_content_size(const uint8_t *, long);
unsigned tcs_crc32c(unsigned, const uint8_t *, long);
int main(int argc, char **argv) {
  int ok = 0, bad = 0;
  for (int i = 1; i + 1 < argc; i += 2) {
    FILE *f = fopen(argv[i], "rb");
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    uint8_t *buf = malloc(n ? n : 1);
    if (fread(buf, 1, n, f) != (size_t)n) return 2;
    fclose(f);
    long cap = atol(argv[i + 1]);
    uint8_t *out = malloc(cap ? cap : 1);
    char err[256];
    tcs_zstd_content_size(buf, n);
    tcs_crc32c(0, buf, n);
    if (tcs_zstd_decompress(buf, n, out, cap, err, 256) >= 0) ok++; else bad++;
    if (tcs_zstd_decompress(buf, n, out, 0, err, 256) >= 0) ok++; else bad++;
    free(out);
    free(buf);
  }
  printf("decoded %d refused %d\n", ok, bad);
  return 0;
}
"""


def payloads(rng) -> list:
    import ml_dtypes

    text = b"".join(rng.choice([b"opt_state", b".zarray", b"params", b"mu", b"nu", b"0.0",
                                b"kernel", b"bias", b"/"], 4000))
    return [rng.standard_normal(20_000).astype(np.float32).tobytes(),
            rng.standard_normal(70_000).astype(ml_dtypes.bfloat16).tobytes(),
            bytes(50_000), b"abcabcabd" * 9_000, text, rng.bytes(300), b"x"]


def valid_frames(rng) -> list:
    import zstandard

    out = []
    for k, data in enumerate(payloads(rng)):
        for level in (1, 3, 9, 19, 22):
            ck, cs = bool(k & 1) ^ (level > 5), bool(level & 1)
            c = zstandard.ZstdCompressor(level=level, write_checksum=ck, write_content_size=cs)
            out.append((c.compress(data), len(data)))
    a, b = out[0], out[7]
    out.append((a[0] + b"\x50\x2a\x4d\x18\x03\x00\x00\x00abc" + b[0], a[1] + b[1]))
    return out


def corrupted(base: bytes, rng) -> bytes:
    d = bytearray(base)
    kind = rng.integers(0, 5)
    if kind == 0:
        for _ in range(rng.integers(1, 4)):
            i = rng.integers(0, len(d))
            d[i] ^= 1 << int(rng.integers(0, 8))
    elif kind == 1:
        for _ in range(rng.integers(1, 8)):
            d[rng.integers(0, len(d))] = rng.integers(0, 256)
    elif kind == 2:
        d = d[:rng.integers(0, len(d))]
    elif kind == 3:
        i = rng.integers(0, len(d))
        d[i:i] = bytes(rng.integers(0, 256, rng.integers(1, 20), dtype=np.uint8))
    else:
        i = rng.integers(0, len(d))
        del d[i:i + rng.integers(1, 20)]
    return bytes(d)


def reference(data: bytes, cap: int):
    """``zstandard``'s reading of ``data`` (every frame), or None where it
    rejects it."""
    import zstandard

    got = b""
    try:
        while True:
            frame = zstandard.ZstdDecompressor().decompressobj()
            got += frame.decompress(data)
            if not frame.eof:  # truncated
                return None
            data = frame.unused_data
            if not data:
                return got if len(got) <= cap else None
    except zstandard.ZstdError:
        return None


def main() -> None:
    from tcs_tpu_torch.utils import zstd

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sanitize", action="store_true")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    bases = valid_frames(rng)
    for frame, size in bases:
        ref = reference(frame, size)
        if ref is None or zstd.decompress(frame, size) != ref:
            sys.exit("a valid frame does not decode as zstandard decodes it")
    cases = []
    for k in range(args.frames):
        frame, size = bases[k % len(bases)]
        cases.append((corrupted(frame, rng), size))
    outcome = collections.Counter()
    for data, cap in cases:
        ref = reference(data, cap)
        try:
            got = zstd.decompress(data, cap)
        except zstd.CorruptZstd:
            outcome["CorruptZstd" + (" (zstandard too)" if ref is None else
                                     " (zstandard decodes it)")] += 1
            continue
        if ref is None:
            outcome["decoded where zstandard refuses"] += 1
        elif got != ref:
            sys.exit("the port decodes a corrupted frame to other bytes than zstandard")
        else:
            outcome["decoded, as zstandard"] += 1
    print(f"in process, through ctypes: {dict(outcome)} of {len(cases)} corrupted frames")
    if outcome["decoded where zstandard refuses"]:
        sys.exit("the port decoded frames that zstandard refuses")
    if args.sanitize:
        with tempfile.TemporaryDirectory() as tmp:
            argv = []
            for k, (data, cap) in enumerate(cases + bases):
                path = os.path.join(tmp, f"{k}.zst")
                with open(path, "wb") as f:
                    f.write(data)
                argv += [path, str(cap)]
            with open(os.path.join(tmp, "harness.c"), "w") as f:
                f.write(HARNESS)
            exe = os.path.join(tmp, "fuzz")
            subprocess.run(["cc", "-g", "-O1", "-fsanitize=address,undefined",
                            "-fno-sanitize-recover=undefined", "-fno-omit-frame-pointer",
                            os.path.join(tmp, "harness.c"),
                            os.path.join(ROOT, "tcs_tpu_torch", "csrc", "zstd.c"), "-o", exe],
                           check=True)
            run = subprocess.run([exe, *argv], capture_output=True, text=True)
            print(f"under ASan and UBSan, {len(argv) // 2} inputs ({len(bases)} valid), each "
                  f"at its capacity and at 0: exit {run.returncode}; {run.stdout.strip()}")
            if run.returncode != 0 or "runtime error" in run.stderr:
                sys.exit(f"the sanitizers reported:\n{run.stderr[-4000:]}")


if __name__ == "__main__":
    main()
