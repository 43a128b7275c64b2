"""FM-index (bwt_t) construction, on-disk I/O, and host-side queries.

Reproduces the reference index artifacts bit-for-bit:
  - BWT string of the doubled (forward+reverse-complement) pack with the
    sentinel row removed, primary = rank of the full text
    (reference: software/is.c:207-223, software/bwtindex.c:62-104)
  - occ-interleaved layout: per 128 bases, a 4xuint64 occurrence
    checkpoint followed by 8 uint32 words of 2-bit packed BWT
    (software/bwtindex.c:128-150, software/bwt.h:71-78)
  - sampled suffix array at interval 32 with sa[0] = -1
    (software/bwt.c:80-102)
  - .bwt/.sa dump/restore formats (software/bwt.c:841-918)

Host-side occ/SA queries here are NumPy-vectorized transcriptions of
bwt_occ/bwt_occ4/bwt_extend/bwt_sa semantics; the device equivalents live in
bwamem_tpu.ops.
"""

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple
import numpy as np

# test/debug escape hatch: force the NumPy prefix-doubling SA even when
# the native SA-IS builder is available (parity A/Bs use both)
_FORCE_NUMPY_SA = bool(os.environ.get("BWAMEM_TPU_NUMPY_SA"))

OCC_INTV_SHIFT = 7
OCC_INTERVAL = 1 << OCC_INTV_SHIFT
OCC_INTV_MASK = OCC_INTERVAL - 1
WORDS_PER_BLOCK = 16  # 8 words checkpoint (4 x u64) + 8 words bwt


def gen_cnt_table() -> np.ndarray:
    """256-entry byte->per-base-count table (bwt_gen_cnt_table,
    software/bwt.c:60-69): entry i packs, per base j, how many of the four
    2-bit fields of byte i equal j, one count per output byte."""
    tbl = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        x = 0
        for j in range(4):
            cnt = (((i & 3) == j) + ((i >> 2 & 3) == j)
                   + ((i >> 4 & 3) == j) + ((i >> 6) == j))
            x |= cnt << (j << 3)
        tbl[i] = x
    return tbl


CNT_TABLE = gen_cnt_table()


@dataclass
class FmIndex:
    """bwt_t: interleaved BWT+occ array, cumulative counts, sampled SA."""
    primary: int = 0
    L2: np.ndarray = field(default_factory=lambda: np.zeros(5, dtype=np.int64))
    seq_len: int = 0
    bwt: Optional[np.ndarray] = None   # uint32, interleaved layout
    sa_intv: int = 0
    sa: Optional[np.ndarray] = None    # int64 (bwtint_t), sa[0] == -1
    # optional denser SA sample (own sidecar format, intv 8): identical
    # lookup VALUES with 4x shorter psi-walks — purely a device-speed
    # artifact, never consulted by the byte-parity host paths
    sa8_intv: int = 0
    sa8: Optional[np.ndarray] = None

    # ---- construction -------------------------------------------------------

    @classmethod
    def build(cls, bases: np.ndarray, sa_intv: int = 32) -> "FmIndex":
        """Build from the doubled base sequence (uint8 0..3).

        Prefers the native SA-IS builder (native/saindex.cpp, ~4.5
        bytes/char peak — the large-genome construction role the
        reference's software/bwt_gen.c fills); falls back to the NumPy
        prefix-doubling path when no compiler is available.  Both yield
        byte-identical artifacts (tests/test_index.py)."""
        from . import nsa
        native = nsa.available() and not _FORCE_NUMPY_SA
        n = int(len(bases))
        fm = cls()
        fm.seq_len = n
        # chunked bincount: np.bincount upcasts its input to intp — an
        # 8 bytes/char transient that would DOMINATE peak RSS at Gbp
        # scale (16 GB for a 1 Gbp genome's doubled text)
        counts = np.zeros(4, dtype=np.int64)
        for lo in range(0, n, 1 << 26):
            counts += np.bincount(bases[lo:lo + (1 << 26)], minlength=4)
        fm.L2 = np.zeros(5, dtype=np.int64)
        fm.L2[1:] = np.cumsum(counts)

        if native:
            sa_full = nsa.suffix_array_native(bases)      # SA[0]==n
        else:
            from .suffix_array import suffix_array
            sa_full = suffix_array(bases)                 # length n+1, SA[0]==n
        # sampled SA straight from the full SA: row r has SA value
        # sa_full[r]; bwt_cal_sa's inverse-Psi walk visits exactly these
        # (software/bwt.c:80-102), with sa[0] forced to -1.  Samples
        # keep sa_full's dtype (int32 under 2^31): every consumer is
        # dtype-agnostic (device tables cast to cdt, dumps to <u8), and
        # int64 would double the resident sample footprint at Gbp scale
        sdt = sa_full.dtype if native else np.int64
        n_sa = (n + sa_intv) // sa_intv
        fm.sa_intv = sa_intv
        fm.sa = sa_full[::sa_intv][:n_sa].astype(sdt)
        fm.sa[0] = -1
        if sa_intv > 8:
            n8 = (n + 8) // 8
            fm.sa8_intv = 8
            fm.sa8 = sa_full[::8][:n8].astype(sdt)
            fm.sa8[0] = -1
        # BWT with the sentinel row removed (is_bwt, is.c:207-223)
        if native:
            bwt_str, fm.primary = nsa.bwt_from_sa(bases, sa_full)
            del sa_full
            fm.bwt = nsa.interleave_occ_native(bwt_str, n)
        else:
            fm.primary = int(np.nonzero(sa_full == 0)[0][0])
            nz = np.concatenate((sa_full[:fm.primary],
                                 sa_full[fm.primary + 1:]))
            bwt_str = bases[nz - 1]
            fm.bwt = interleave_occ(bwt_str, n)
        return fm

    # ---- derived ------------------------------------------------------------

    @property
    def bwt_size(self) -> int:
        return int(len(self.bwt))

    def blocks(self) -> np.ndarray:
        """Interleaved array as (n_blocks, 16) uint32 — one row is one
        64-byte occ block, the unit the FPGA gathers per extension step
        and the row our device kernels gather from device memory."""
        return self.bwt.reshape(-1, WORDS_PER_BLOCK)

    # ---- scalar/NumPy queries (host oracle path) ----------------------------

    def B0(self, k: int) -> int:
        """bwt_B0: BWT character at $-removed position k (bwt.h:72-78)."""
        w = self.bwt[((k >> 7) << 4) + 8 + ((k & 0x7F) >> 4)]
        return int(w >> ((~k & 0xF) << 1)) & 3

    def occ(self, k: int, c: int) -> int:
        """bwt_occ (software/bwt.c:125-147)."""
        if k == self.seq_len:
            return int(self.L2[c + 1] - self.L2[c])
        if k == -1:
            return 0
        k -= 1 if k >= self.primary else 0
        blk = k >> 7
        base = blk << 4
        ck = self.bwt[base:base + 8].view(np.uint64)
        n = int(ck[c])
        words = self.bwt[base + 8:base + 16]
        # whole 32-base (2-word) groups before k's group
        n_groups = (k >> 5) - ((k & ~OCC_INTV_MASK) >> 5)
        for g in range(n_groups):
            y = (int(words[2 * g]) << 32) | int(words[2 * g + 1])
            n += _occ_aux64(y, c)
        y = (int(words[2 * n_groups]) << 32) | int(words[2 * n_groups + 1])
        y &= ~((1 << ((~k & 31) << 1)) - 1) & 0xFFFFFFFFFFFFFFFF
        n += _occ_aux64(y, c)
        if c == 0:
            n -= ~k & 31  # correct for masked positions counted as base 0
        return n

    def occ4(self, k: int) -> np.ndarray:
        """bwt_occ4 (software/bwt.c:187-204)."""
        cnt = np.zeros(4, dtype=np.int64)
        if k == -1:
            return cnt
        k -= 1 if k >= self.primary else 0
        base = (k >> 7) << 4
        cnt[:] = self.bwt[base:base + 8].view(np.uint64).astype(np.int64)
        words = self.bwt[base + 8:base + 16]
        n_words = (k >> 4) - ((k & ~OCC_INTV_MASK) >> 4)
        x = 0
        for w in range(n_words):
            x += _occ_aux4(int(words[w]))
        tmp = int(words[n_words]) & (~((1 << ((~k & 15) << 1)) - 1) & 0xFFFFFFFF)
        x += _occ_aux4(tmp) - (~k & 15)
        cnt[0] += x & 0xFF
        cnt[1] += (x >> 8) & 0xFF
        cnt[2] += (x >> 16) & 0xFF
        cnt[3] += (x >> 24) & 0xFF
        return cnt

    def occ2_4(self, k: int, l: int) -> Tuple[np.ndarray, np.ndarray]:
        """bwt_2occ4 — the reference simplified it to two bwt_occ4 calls
        (software/bwt.c:207-214)."""
        return self.occ4(k), self.occ4(l)

    def extend(self, ik, is_back: int):
        """bwt_extend (software/bwt.c:416-429).  ik/ok are (x0, x1, s, info)
        tuples of Python ints; returns list of 4 ok intervals."""
        x0, x1, s, info = ik
        fwd = x1 if not is_back else x0
        tk = self.occ4(fwd - 1)
        tl = self.occ4(fwd - 1 + s)
        ok = [[0, 0, 0, info] for _ in range(4)]
        for i in range(4):
            if is_back:
                ok[i][0] = int(self.L2[i]) + 1 + int(tk[i])
            else:
                ok[i][1] = int(self.L2[i]) + 1 + int(tk[i])
            ok[i][2] = int(tl[i]) - int(tk[i])
        bump = 1 if (fwd <= self.primary and fwd + s - 1 >= self.primary) else 0
        other = 1 if is_back else 0
        prev = (x1 if is_back else x0) + bump
        ok[3][other] = prev
        ok[2][other] = ok[3][other] + ok[3][2]
        ok[1][other] = ok[2][other] + ok[2][2]
        ok[0][other] = ok[1][other] + ok[1][2]
        return [tuple(o) for o in ok]

    def sa_lookup(self, k: int) -> int:
        """bwt_sa: walk inverse Psi to the previous sampled row
        (software/bwt.c:104-114).  Native C walk when available
        (oracle/nsmem.py); the Python walk below is the spec."""
        from ..oracle import nsmem, smem as _osmem
        if _osmem._NATIVE and nsmem.available():
            v = nsmem.sa_lookup_batch_native(self, [k])
            if v is not None:
                return int(v[0])
        sa = 0
        mask = self.sa_intv - 1
        while k & mask:
            sa += 1
            k = self.inv_psi(k)
        return sa + int(self.sa[k // self.sa_intv])

    def inv_psi(self, k: int) -> int:
        """bwt_invPsi (software/bwt.c:71-77)."""
        x = k - (1 if k > self.primary else 0)
        c = self.B0(x)
        x = int(self.L2[c]) + self.occ(k, c)
        return 0 if k == self.primary else x

    def set_intv(self, c: int):
        """bwt_set_intv (software/bwt.h:80): initial bi-interval of base c."""
        return (int(self.L2[c]) + 1,
                int(self.L2[3 - c]) + 1,
                int(self.L2[c + 1] - self.L2[c]),
                0)

    # ---- on-disk formats -----------------------------------------------------

    def dump_bwt(self, path: str) -> None:
        with open(path, "wb") as f:
            np.int64(self.primary).tofile(f)
            self.L2[1:5].astype("<u8").tofile(f)
            self.bwt.astype("<u4").tofile(f)

    def dump_sa8(self, path: str) -> None:
        """Dense-SA sidecar (our own artifact, not a bwa format).
        Chunked writes: a whole-array astype would transiently double
        the ~1 GB/Gbp sample at human scale."""
        with open(path, "wb") as f:
            np.int64(self.seq_len).tofile(f)
            np.int64(self.sa8_intv).tofile(f)
            for lo in range(1, len(self.sa8), 1 << 26):
                self.sa8[lo:lo + (1 << 26)].astype("<u8").tofile(f)

    def restore_sa8(self, path: str) -> bool:
        import os as _os
        if not _os.path.exists(path):
            return False
        with open(path, "rb") as f:
            head = np.fromfile(f, dtype="<u8", count=2)
            if len(head) != 2 or int(head[0]) != self.seq_len:
                return False
            intv = int(head[1])
            n8 = (self.seq_len + intv) // intv
            vals = np.fromfile(f, dtype="<u8", count=n8 - 1)
            if len(vals) != n8 - 1:
                return False
            self.sa8_intv = intv
            self.sa8 = np.empty(n8, dtype=np.int64)
            self.sa8[0] = -1
            self.sa8[1:] = vals.astype(np.int64)
        return True

    def dump_sa(self, path: str) -> None:
        with open(path, "wb") as f:
            np.int64(self.primary).tofile(f)
            self.L2[1:5].astype("<u8").tofile(f)
            np.int64(self.sa_intv).tofile(f)
            np.int64(self.seq_len).tofile(f)
            self.sa[1:].astype("<u8").tofile(f)

    @classmethod
    def restore(cls, bwt_path: str, sa_path: Optional[str] = None) -> "FmIndex":
        fm = cls()
        with open(bwt_path, "rb") as f:
            head = np.fromfile(f, dtype="<u8", count=5)
            fm.primary = int(head[0])
            fm.L2 = np.zeros(5, dtype=np.int64)
            fm.L2[1:] = head[1:].astype(np.int64)
            fm.bwt = np.fromfile(f, dtype="<u4")
        fm.seq_len = int(fm.L2[4])
        if sa_path:
            with open(sa_path, "rb") as f:
                head = np.fromfile(f, dtype="<u8", count=7)
                assert int(head[0]) == fm.primary, "SA-BWT inconsistency: primary"
                fm.sa_intv = int(head[5])
                assert int(head[6]) == fm.seq_len, "SA-BWT inconsistency: seq_len"
                n_sa = (fm.seq_len + fm.sa_intv) // fm.sa_intv
                fm.sa = np.empty(n_sa, dtype=np.int64)
                fm.sa[0] = -1
                fm.sa[1:] = np.fromfile(f, dtype="<u8", count=n_sa - 1).astype(np.int64)
        return fm


def _occ_aux64(y: int, c: int) -> int:
    """__occ_aux (software/bwt.c:116-123): count of base c among the 32
    2-bit fields of y (high-to-low), via bit tricks + popcount."""
    m = y if (c & 2) else ~y
    m = (m >> 1) & (y if (c & 1) else ~y) & 0x5555555555555555
    return bin(m & 0xFFFFFFFFFFFFFFFF).count("1")


def _occ_aux4(b: int) -> int:
    """__occ_aux4: per-base packed counts of one uint32 word via the
    cnt_table (software/bwt.c:183-185)."""
    return int(CNT_TABLE[b & 0xFF] + CNT_TABLE[(b >> 8) & 0xFF]
               + CNT_TABLE[(b >> 16) & 0xFF] + CNT_TABLE[b >> 24])


def interleave_occ(bwt_str: np.ndarray, seq_len: int) -> np.ndarray:
    """Produce the occ-interleaved uint32 array from the raw BWT string
    (bwt_bwtupdate_core semantics, software/bwtindex.c:128-150):
    every 128 bases, write the 4 cumulative counts as 4 uint64 (viewed as
    8 uint32 in native little-endian order) followed by 8 words of 2-bit
    packed BWT; a final checkpoint-only block closes the array."""
    n = seq_len
    n_plain_words = (n + 15) >> 4
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_occ = n_blocks + 1
    out = np.zeros(n_plain_words + n_occ * 8, dtype=np.uint32)

    # pack BWT, 16 bases per word, MSB-first
    padded = np.zeros(n_plain_words << 4, dtype=np.uint32)
    padded[:n] = bwt_str
    shifts = (15 - np.arange(16, dtype=np.uint32)) * 2
    plain = (padded.reshape(-1, 16) << shifts[None, :]).sum(axis=1, dtype=np.uint32)

    # cumulative per-base counts at block boundaries: occ[b] = counts of
    # bwt_str[:min(b*128, n)]
    occ = np.zeros((n_occ, 4), dtype=np.uint64)
    onehot = np.zeros((4, n), dtype=np.int64)
    for c in range(4):
        onehot[c] = bwt_str == c
    csum = np.cumsum(onehot, axis=1)
    bounds = np.minimum(np.arange(1, n_occ, dtype=np.int64) * OCC_INTERVAL, n)
    occ[1:] = csum[:, bounds - 1].T.astype(np.uint64)

    # interleave; the last block may carry fewer than 8 bwt words, and the
    # closing checkpoint follows immediately after them
    pos = 0
    for b in range(n_blocks):
        out[pos:pos + 8] = occ[b].view(np.uint32)
        pos += 8
        w0 = b * 8
        w1 = min(w0 + 8, n_plain_words)
        out[pos:pos + (w1 - w0)] = plain[w0:w1]
        pos += w1 - w0
    out[pos:pos + 8] = occ[n_blocks].view(np.uint32)
    assert pos + 8 == len(out), "inconsistent bwt_size"
    return out
