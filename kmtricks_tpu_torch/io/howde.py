"""Per-sample Bloom filter files: HowDe-SBT ``.bf`` and SDSL ``.sdsl``.

Copy of ``kmtricks_tpu/io/howde.py`` (the writer, ``write_bf_file``, and
its helpers), for ``stage_format``. Reference:
include/kmtricks/howde_utils.hpp:56-122 (write_header) — the header is
written twice: first with the "unfinished" magic, then seek(0) and
rewrite with the final magic once the bit payload is complete. The single
bit-vector entry is an SDSL-serialized bit_vector (u64 bit count, then the
bits packed into little-endian u64 words), ``numBytes = bloom/8 + 8``.

The five HowDeSBT ``bloom_filter_file.h`` constants are placeholders in
the original (the header is not vendored in the reference tree), with the
same environment overrides for interop with a real HowDeSBT install:
``KMTRICKS_TPU_BF_MAGIC`` / ``KMTRICKS_TPU_BF_MAGIC_UN`` /
``KMTRICKS_TPU_BF_VERSION`` / ``KMTRICKS_TPU_BFKIND_SIMPLE`` /
``KMTRICKS_TPU_BVCOMP_UNCOMPRESSED``.
"""

from __future__ import annotations

import os
import struct

import numpy as np


def _const(env: str, default: int) -> int:
    v = os.environ.get(env)
    return int(v, 0) if v is not None else default


# HowDeSBT bloom_filter_file.h constants (see module docstring caveat:
# placeholders, overridable via environment for real-HowDeSBT interop)
BF_MAGIC_UNFINISHED = _const("KMTRICKS_TPU_BF_MAGIC_UN", 0xD0B10F20D0B10F20)
BF_MAGIC = _const("KMTRICKS_TPU_BF_MAGIC", 0xD0B10F21D0B10F21)
BF_VERSION = _const("KMTRICKS_TPU_BF_VERSION", 2)
BFKIND_SIMPLE = _const("KMTRICKS_TPU_BFKIND_SIMPLE", 1)
BVCOMP_UNCOMPRESSED = _const("KMTRICKS_TPU_BVCOMP_UNCOMPRESSED", 0)

# bffileheader field layout: magic, headerSize, version, bfKind,
# (explicit padding1), smerSize, numHashes, hashSeed1/2, hashModulus,
# numBits, numVectors, setSizeKnown, setSize — per the public HowDeSBT
# bloom_filter_file.h struct (padding1 sits between bfKind and smerSize)
_HDR = struct.Struct("<QIII4xIIQQQQI?3xQ")     # bffileheader (no info[])
_INFO = struct.Struct("<IIQQQ")                # bfvectorinfo
_PREFIX_SIZE = 16                              # sizeof(bffileprefix)


def _round_up_16(b: int) -> int:
    return (b + 15) & ~15


def header_size(num_vectors: int = 1) -> int:
    return _round_up_16(_HDR.size + num_vectors * _INFO.size)


def _header_bytes(magic: int, hsize_field: int, bloom_size: int,
                  kmer_size: int, total: int) -> bytes:
    hdr = _HDR.pack(magic, hsize_field, BF_VERSION, BFKIND_SIMPLE,
                    kmer_size, 1, 0, 0, bloom_size, bloom_size, 1, False, 0)
    info = _INFO.pack(BVCOMP_UNCOMPRESSED, 0, total,
                      bloom_size // 8 + 8, 0)
    out = hdr + info
    return out + b"\x00" * (total - len(out))


def bits_to_sdsl_words(bits: np.ndarray, bloom_size: int) -> np.ndarray:
    """Bit payload (LSB-first bytes) -> SDSL u64 word array."""
    raw = np.asarray(bits, dtype=np.uint8).ravel()
    nbytes = (bloom_size + 63) // 64 * 8
    buf = np.zeros(nbytes, dtype=np.uint8)
    buf[:len(raw)] = raw[:nbytes]
    return buf.view(np.uint64)


def write_bf_file(path: str, bits: np.ndarray, bloom_size: int,
                  kmer_size: int, fmt: str = "howdesbt") -> None:
    """Write one sample's full Bloom filter.

    ``bits``: LSB-first packed bytes, partition windows already concatenated
    in partition order (bit h of the filter = bit h%8 of byte h//8).
    ``fmt``: "howdesbt" (bffileheader + sdsl vector) or "sdsl" (bare
    sdsl::bit_vector serialization).
    """
    words = bits_to_sdsl_words(bits, bloom_size)
    if fmt == "sdsl":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", bloom_size))
            f.write(words.tobytes())
        return
    total = header_size(1)
    with open(path, "wb") as f:
        # first pass: zeroed header carrying only the unfinished magic and
        # headerSize=sizeof(bffileprefix) (write_header zero-initialises the
        # buffer with `new char[header_size]()`, howde_utils.hpp:59-64)
        unfinished = bytearray(total)
        unfinished[:16] = struct.pack("<QI4x", BF_MAGIC_UNFINISHED,
                                      _PREFIX_SIZE)
        f.write(bytes(unfinished))
        f.write(struct.pack("<Q", bloom_size))
        f.write(words.tobytes())
        # rewrite with final magic and full fields
        f.seek(0)
        f.write(_header_bytes(BF_MAGIC, total, bloom_size, kmer_size, total))
