#!/usr/bin/env python
"""Corrupted JPEG files through the port's decoder: none may crash it.

The decoder runs in the process that drives the card, through ctypes, so a
corrupt file must raise (``CorruptJPEG``, ``UnsupportedJPEG`` or
``MemoryError``) or decode, never crash the process. This writes valid
files (baseline, progressive, restart markers, optimised tables, gray;
PIL), corrupts copies of them (bytes changed, cut, inserted, or a marker
planted), and decodes each through ``tcs_tpu_torch.data.jpeg.read_jpeg`` in
this process. With ``--sanitize`` it also builds ``csrc/jpeg.c`` with a
small C driver under AddressSanitizer and UBSan (``cc
-fsanitize=address,undefined``) and runs the same files through it (each
decoded image is also re-encoded there), failing on any report. Prints the
counts of each outcome.

Usage: ``python scripts/jpeg_fuzz.py [--files 4000] [--seed 0] [--sanitize]``
(the CPU; it imports PIL).
"""

from __future__ import annotations

import argparse
import collections
import io
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DRIVER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
int tcs_jpeg_info(const uint8_t *, long, int *, int *, int *, int *, char *, int);
int tcs_jpeg_decode(const uint8_t *, long, uint8_t *, long, char *, int);
long tcs_jpeg_encode(const uint8_t *, int, int, int, uint8_t *, long);
int main(int argc, char **argv) {
  int ok = 0, bad = 0;
  for (int i = 1; i < argc; i++) {
    FILE *f = fopen(argv[i], "rb");
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    uint8_t *buf = malloc(n ? n : 1);
    if (fread(buf, 1, n, f) != (size_t)n) return 2;
    fclose(f);
    int w, h, c, p;
    char err[256];
    if (tcs_jpeg_info(buf, n, &w, &h, &c, &p, err, 256) == 0 && (long)w * h * c < (1L << 28)) {
      uint8_t *out = malloc((size_t)w * h * c);
      if (tcs_jpeg_decode(buf, n, out, (long)w * h * c, err, 256) == 0) {
        ok++;
        if (c == 3) {
          long cap = (long)w * h * 3 + 4096;
          uint8_t *e = malloc(cap);
          tcs_jpeg_encode(out, w, h, 95, e, cap);
          free(e);
        }
      } else {
        bad++;
      }
      free(out);
    } else {
      bad++;
    }
    free(buf);
  }
  printf("decoded %d refused %d\n", ok, bad);
  return 0;
}
"""


def valid_files(rng) -> list:
    from PIL import Image, ImageFile

    ImageFile.MAXBLOCK = 1 << 22
    out = []
    for kw in (dict(quality=90), dict(quality=75, progressive=True),
               dict(quality=95, subsampling=0, restart_marker_blocks=2),
               dict(quality=50, optimize=True, subsampling=1),
               dict(quality=80, progressive=True, restart_marker_blocks=1)):
        for shape in ((37, 45, 3), (8, 8), (1, 1, 3), (17, 3, 3)):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(buf, "JPEG", **kw)
            out.append(buf.getvalue())
    return out


def corrupted(base: bytes, rng) -> bytes:
    d = bytearray(base)
    kind = rng.integers(0, 4)
    if kind == 0:
        for _ in range(rng.integers(1, 8)):
            d[rng.integers(0, len(d))] = rng.integers(0, 256)
    elif kind == 1:
        d = d[:rng.integers(0, len(d))]
    elif kind == 2:
        i = rng.integers(0, len(d))
        d[i:i] = bytes(rng.integers(0, 256, rng.integers(1, 20), dtype=np.uint8))
    else:
        i = rng.integers(2, len(d) - 2)
        d[i], d[i + 1] = 0xFF, rng.integers(0xC0, 0x100)
    return bytes(d)


def main() -> None:
    from tcs_tpu_torch.data import jpeg

    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sanitize", action="store_true")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    bases = valid_files(rng)
    files = [corrupted(bases[k % len(bases)], rng) for k in range(args.files)]
    outcome = collections.Counter()
    for data in files:
        try:
            jpeg.read_jpeg(data)
            outcome["decoded"] += 1
        except (jpeg.CorruptJPEG, jpeg.UnsupportedJPEG, MemoryError) as e:
            outcome[type(e).__name__] += 1
    print(f"in process, through ctypes: {dict(outcome)} of {len(files)} corrupted files")
    if args.sanitize:
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for k, data in enumerate(files + bases):
                paths.append(os.path.join(tmp, f"{k}.jpg"))
                with open(paths[-1], "wb") as f:
                    f.write(data)
            with open(os.path.join(tmp, "driver.c"), "w") as f:
                f.write(DRIVER)
            exe = os.path.join(tmp, "fuzz")
            subprocess.run(["cc", "-g", "-O1", "-fsanitize=address,undefined",
                            "-fno-sanitize-recover=undefined", "-fno-omit-frame-pointer",
                            os.path.join(tmp, "driver.c"),
                            os.path.join(ROOT, "tcs_tpu_torch", "csrc", "jpeg.c"), "-o", exe],
                           check=True)
            run = subprocess.run([exe, *paths], capture_output=True, text=True)
            print(f"under ASan and UBSan, {len(paths)} files ({len(bases)} valid): exit "
                  f"{run.returncode}; {run.stdout.strip()}")
            if run.returncode != 0 or "runtime error" in run.stderr:
                sys.exit(f"the sanitizers reported:\n{run.stderr[-4000:]}")


if __name__ == "__main__":
    main()
