"""The codeword steps of K5 and K7 (``csrc/fsm.cu``) on the CPU: the
codeword table against a bit walk for every k-bit prefix, and a Python
model of each kernel's walk against the plain versions.

The K5 model steps a chunk's walks a codeword at a time through the
table, always the walk at the lowest position, and merges walks that
land on one position (the later started into the earlier), with the
kernel's position mask, its slot ring indexed by position (16-bit slots
for codes under 32 bits) and its packed results; codes longer than 63
bits take the kernel's other path (W0's boundary bitmap with prefix
counts by word, later offsets walking until they reach it).  The K7 model walks each chunk from its true entry
in the kernel's staged rounds (32 symbols a lane, then the warp's lanes
stored in turn).  Each is held to ``fsm_sweep_plain`` / ``fsm_emit_plain``
(the bit-by-bit semantics, held to a serial walk and to the Pallas decode
by ``tests/test_torch_fsm.py``) on that file's stream families.
Tolerance: exact (equal maps, counts and symbols).

Run as a script, it prints the model's codeword steps on the ABS and
PW_REL streams of ``chip_smoke.field``:
``PYTHONPATH=. python tests/test_torch_fsm_lut.py [n]`` from the root
of the repository (an n^3 field, default 128).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu_torch.format import huffman
from sz_tpu_torch.gpu import fsm_kernel as fk

PAYLOAD = fk.LUT_PAYLOAD - 1
STAGE = 32          # fsm.cu kStage


# --- trees and streams ----------------------------------------------------

def _zipf(seed, n, nstate, a):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, nstate + 1) ** a
    return rng.choice(np.arange(nstate), size=n,
                      p=p / p.sum()).astype(np.int32)


def _caterpillar(depth):
    """Code k is k ones then a zero, the last one ``depth`` ones."""
    nc = 2 * depth + 1
    L, R = np.zeros(nc, np.uint32), np.zeros(nc, np.uint32)
    C, T = np.zeros(nc, np.uint32), np.zeros(nc, np.uint8)
    for k in range(depth):
        node, zero_leaf = (0 if k == 0 else depth + k), k + 1
        L[node], C[zero_leaf], T[zero_leaf] = zero_leaf, k, 1
        R[node] = depth + k + 1 if k + 1 < depth else 2 * depth
    C[2 * depth], T[2 * depth] = depth, 1
    return L, R, C, T


def _tables_case(types, nstate):
    t = huffman.build_tables(types, nstate)
    return (t.L, t.R, t.C, t.T), huffman.encode(t, types)


def _random(nbytes, seed, ones_at=None, ones=0):
    raw = np.random.default_rng(seed).integers(0, 256, nbytes).astype(
        np.uint8)
    if ones_at is not None:
        raw[ones_at:ones_at + ones] = 0xFF
    return raw.tobytes()


def _big_symbols():
    """A skewed tree whose symbols are 2^27 and up: every table entry
    that would name them falls back to a bit walk from the root."""
    tree, enc = _tables_case(_zipf(5, 3000, 60, 1.3), 60)
    L, R, C, T = tree
    C = C.astype(np.int64)
    C[T != 0] += 1 << 27
    return (L, R, C.astype(np.uint32), T), enc


def stream(name):
    """(L, R, C, T), coded bytes: the stream families of
    tests/test_torch_fsm.py, and codes of 40 (the 64-slot ring) and 1100
    bits (the wide path, F = 2048)."""
    if name == "skewed_40k":
        return _tables_case(_zipf(29, 40000, 600, 1.5), 600)
    if name == "random_bits_zipf":
        t = huffman.build_tables(_zipf(37, 3000, 200, 1.2), 200)
        return (t.L, t.R, t.C, t.T), _random(5 * 128 - 37, 37)
    if name == "never_syncs":
        return _tables_case(
            np.random.default_rng(47).integers(0, 8, 6000).astype(np.int32),
            8)
    if name == "fixed_9_bits":
        return _tables_case(
            np.random.default_rng(61).integers(0, 512, 4000).astype(
                np.int32), 512)
    if name == "tree_past_8192_nodes":
        return _tables_case(_zipf(41, 60000, 6000, 0.9), 6000)
    if name == "under_2^16_bits":
        return _tables_case(_zipf(43, 900, 50, 1.5), 50)
    if name == "symbols_past_2^26":
        return _big_symbols()
    if name == "caterpillar_40":
        return _caterpillar(40), _random(3000, 40, 1000, 6)
    if name == "caterpillar_130":
        return _caterpillar(130), _random(5 * 128 - 37, 37)
    if name == "caterpillar_1100":
        return _caterpillar(1100), _random(6000, 1100, 1000, 140)
    raise KeyError(name)


STREAMS = ["skewed_40k", "random_bits_zipf", "never_syncs", "fixed_9_bits",
           "tree_past_8192_nodes", "under_2^16_bits", "symbols_past_2^26",
           "caterpillar_40", "caterpillar_130", "caterpillar_1100"]


# --- the codeword table ---------------------------------------------------

def _bit_walk_entry(tree, x, k):
    """The table entry of prefix x (k bits) by a walk over L/R/C/T."""
    L, R, C, T = tree
    s = 0
    for i in range(k):
        s = int(R[s] if (x >> (k - 1 - i)) & 1 else L[s])
        if T[s]:
            sym = int(C[s])
            return (fk.LEAF | (i + 1) << 26 | sym) if sym < fk.LUT_PAYLOAD \
                else 0
    return k << 26 | s if s < fk.LUT_PAYLOAD else 0


def _one_level():
    return (np.array([1, 0, 0], np.uint32), np.array([2, 0, 0], np.uint32),
            np.array([0, 7, 9], np.uint32), np.array([0, 1, 1], np.uint8))


@pytest.mark.parametrize("name", [
    "skewed_40k", "tree_past_8192_nodes", "caterpillar_40",
    "caterpillar_1100", "never_syncs", "fixed_9_bits", "symbols_past_2^26",
    "one_level"])
def test_lut_matches_a_bit_walk(name):
    tree = _one_level() if name == "one_level" else stream(name)[0]
    depth = fk.code_depth(tree[0], tree[1], tree[3])
    lut = fk.build_lut(fk.build_trans(*tree), depth)
    k = min(fk.LUT_BITS, depth)
    assert lut.dtype == np.int32 and lut.shape == (1 << k,)
    want = np.array([_bit_walk_entry(tree, x, k) for x in range(1 << k)],
                    np.int64).astype(np.uint32)
    np.testing.assert_array_equal(lut.view(np.uint32), want)
    if name == "symbols_past_2^26":
        assert (lut == 0).sum() > 0
    if name in ("never_syncs", "fixed_9_bits", "one_level"):
        assert (lut < 0).all()          # every code resolves in the table


def test_constants_match_the_cuda_source():
    """The window depth the wrapper sizes K5's scratch by, and the model's
    stage, are fsm.cu's."""
    src = (pathlib.Path(fk.__file__).resolve().parent.parent / "csrc"
           / "fsm.cu").read_text()
    assert f"constexpr int kWindowDepth = {fk.WINDOW_DEPTH};" in src
    assert f"constexpr int kStage = {STAGE};" in src
    assert f"constexpr int kPayload = (1 << 26) - 1;" in src
    assert fk.LUT_PAYLOAD == 1 << 26


def test_lut_refuses_a_table_past_its_limit():
    """The wrappers take only build_lut's table of min(12, D) bits: a
    14-bit table, or one of the right size in another dtype, is refused
    before any kernel could index past it."""
    coded = fk.upload((*stream("caterpillar_130")[0], 261),
                      _random(256, 3), "cpu")
    assert coded.lut.shape == (1 << fk.LUT_BITS,)
    for lut in (torch.zeros(1 << 14, dtype=torch.int32),
                coded.lut.to(torch.int64), None):
        with pytest.raises(ValueError, match="codeword table"):
            fk.fsm_sweep(coded._replace(lut=lut))
    L = coded.bits.numel() * 8 // fk.chunk_bits(coded.depth)
    with pytest.raises(ValueError, match="codeword table"):
        fk.fsm_emit(coded._replace(lut=torch.zeros(1 << 14,
                                                   dtype=torch.int32)),
                    torch.zeros(L, dtype=torch.int32),
                    torch.zeros(L, dtype=torch.int64), 4)


# --- the models -----------------------------------------------------------

class Stream:
    """A coded stream as the kernels see it: padded bytes, tables, F."""

    def __init__(self, tree, enc):
        self.depth = fk.code_depth(tree[0], tree[1], tree[3])
        self.F = fk.chunk_bits(self.depth)
        self.trans = fk.build_trans(*tree)
        self.lut = fk.build_lut(self.trans, self.depth)
        self.k = min(fk.LUT_BITS, self.depth)
        self.padded = fk.pad_stream(enc, "cpu", self.F)
        self.u8 = self.padded.numpy().tobytes()
        self.total_bits = 8 * len(enc)
        self.L = len(self.u8) * 8 // self.F
        self._t = self.trans.tolist()
        self._lut = self.lut.tolist()

    def window(self, pos):
        """32 bits from bit pos, the first in bit 31; 0 past the end."""
        b = self.u8[pos >> 3:(pos >> 3) + 5].ljust(5, b"\0")
        return (int.from_bytes(b, "big") >> (8 - (pos & 7))) & 0xFFFFFFFF

    def limit(self, c):
        left = self.total_bits - c * self.F
        return 0 if left <= 0 else min(left, self.F + self.depth)

    def codeword(self, c, q, lim):
        """codeword() of fsm.cu: (bit after the code or -1, symbol)."""
        base = c * self.F
        e = self._lut[self.window(base + q) >> (32 - self.k)]
        ln = (e >> 26) & 31
        if e < 0:
            return (q + ln if q + ln <= lim else -1), e & PAYLOAD
        s, q = e & PAYLOAD, q + ln
        while q < lim:
            v = self._t[2 * s + (self.window(base + q) >> 31)]
            q += 1
            if v < 0:
                return q, v & 0x7FFFFFFF
            s = v
        return -1, None


def sweep_window(st, c):
    """fsm_sweep_kernel<kW> on chunk c: (g row, n row, codeword steps)."""
    F, D = st.F, st.depth
    kW = 32 if D < 32 else 64
    kid = 5 if kW == 32 else 6          # slot: id | count << kid
    lim = st.limit(c)
    qend = min(F, lim)
    slot, res = [0] * kW, [0] * D
    live = 0
    for j in range(D):
        if j < lim:
            slot[j] = j
            live |= 1 << j
    cur = steps = 0
    while live and cur < qend:
        sv = slot[cur & (kW - 1)]
        wid, cnt = sv & (kW - 1), sv >> kid
        q, _ = st.codeword(c, cur, lim)
        steps += 1
        live &= ~1
        if q < 0:
            res[wid] = max(lim - F, 0) | cnt << 7
        else:
            cnt += 1
            d, qi = q - cur, q & (kW - 1)
            assert 1 <= d <= D and d < 64
            if (live >> d) & 1:
                ov = slot[qi]
                oid, ocnt = ov & (kW - 1), ov >> kid
                if oid < wid:
                    res[wid] = (cnt - ocnt) << 7 | 64 | oid
                else:
                    res[oid] = (ocnt - cnt) << 7 | 64 | wid
                    slot[qi] = wid | cnt << kid
            else:
                live |= 1 << d
                slot[qi] = wid | cnt << kid
            assert slot[qi] < (1 << 16 if kW == 32 else 1 << 31)
        if live:
            s = (live & -live).bit_length() - 1
            live >>= s
            cur += s
    while live:
        p = cur + (live & -live).bit_length() - 1
        sv = slot[p & (kW - 1)]
        assert max(p - F, 0) < 64
        res[sv & (kW - 1)] = max(p - F, 0) | (sv >> kid) << 7
        live &= live - 1
    for j in range(D):
        r = res[j]
        if r & 64:
            rt = res[r & 63]
            assert r & 63 < j and not rt & 64
            res[j] = ((r >> 7) + (rt >> 7)) << 7 | (rt & 63)
    return [r & 63 for r in res], [r >> 7 for r in res], steps


def sweep_wide(st, c):
    """fsm_sweep_wide_kernel on chunk c: (g row, n row, codeword
    steps)."""
    F, D = st.F, st.depth
    lim = st.limit(c)
    qend = min(F, lim)
    nw = (F + D) // 32 + 1
    bm = [0] * nw
    p = n0 = steps = 0
    cut = False
    while p < qend:
        q, _ = st.codeword(c, p, lim)
        steps += 1
        if q < 0:
            cut = True
            break
        n0, p = n0 + 1, q
        bm[p >> 5] |= 1 << (p & 31)
    g0 = max(lim - F, 0) if cut else max(p - F, 0)
    pre, run = [], 0
    for w in bm:
        pre.append(run)
        run += bin(w).count("1")
    g, n = [0] * D, [0] * D
    for j in range(D):
        if j >= lim:
            continue
        own, p = 0, j
        while True:
            wd = bm[p >> 5]
            if (wd >> (p & 31)) & 1 or p == 0:
                rank = 0 if p == 0 else pre[p >> 5] + bin(
                    wd & (0xFFFFFFFF >> (31 - (p & 31)))).count("1")
                g[j], n[j] = g0, own + n0 - rank
                break
            if p >= qend:
                g[j], n[j] = max(p - F, 0), own
                break
            q, _ = st.codeword(c, p, lim)
            steps += 1
            if q < 0:
                g[j], n[j] = max(lim - F, 0), own
                break
            own, p = own + 1, q
    return g, n, steps


def sweep_model(st, chunks=None):
    """K5's maps (int32 (L, D), int64 (L, D)) and each chunk's codeword
    steps, by the kernel's path for this depth."""
    walk = sweep_window if st.depth <= fk.WINDOW_DEPTH else sweep_wide
    chunks = range(st.L) if chunks is None else chunks
    rows = [walk(st, c) for c in chunks]
    g = torch.tensor([r[0] for r in rows], dtype=torch.int32)
    n = torch.tensor([r[1] for r in rows], dtype=torch.int64)
    return g, n, np.array([r[2] for r in rows])


def distinct_boundaries(st, c):
    """The boundaries of chunk c that some walk from an offset j < D
    leaves at the root below min(F, lim): each needs one decode."""
    lim = st.limit(c)
    qend = min(st.F, lim)
    todo = sorted(j for j in range(st.depth) if j < lim)
    seen, heap = set(), list(todo)
    while heap:
        p = heap.pop()
        if p in seen or p >= qend:
            continue
        seen.add(p)
        q, _ = st.codeword(c, p, lim)
        if q >= 0:
            heap.append(q)
    return len(seen)


def emit_model(st, entry, offsets, n_sym):
    """fsm_emit_kernel: symbols staged STAGE a lane a round, each warp's
    lanes stored in turn.  Returns (int32 symbols, codeword steps a
    chunk, rounds a warp)."""
    out = np.zeros(n_sym, np.int32)
    steps = np.zeros(st.L, np.int64)
    rounds = []
    for w0 in range(0, st.L, 32):
        lanes = range(w0, min(w0 + 32, st.L))
        lim = {c: st.limit(c) for c in lanes}
        qend = {c: min(st.F, lim[c]) for c in lanes}
        q = {c: int(entry[c]) for c in lanes}
        o = {c: int(offsets[c]) for c in lanes}
        r = 0
        while any(q[c] < qend[c] for c in lanes):
            r += 1
            buf = {}
            for c in lanes:
                buf[c] = []
                while len(buf[c]) < STAGE and q[c] < qend[c]:
                    q2, sym = st.codeword(c, q[c], lim[c])
                    steps[c] += 1
                    if q2 < 0:
                        q[c] = qend[c]
                        break
                    buf[c].append(sym)
                    q[c] = q2
            for c in lanes:                 # the warp's stores, lane order
                for i, sym in enumerate(buf[c]):
                    if o[c] + i < n_sym:
                        out[o[c] + i] = sym
                o[c] += len(buf[c])
        rounds.append(r)
    return torch.from_numpy(out), steps, np.array(rounds)


def warp_max(per_chunk):
    """The largest count of each warp's 32 chunks, per warp."""
    a = np.asarray(per_chunk)
    pad = np.zeros(-len(a) % 32, a.dtype)
    return np.concatenate([a, pad]).reshape(-1, 32).max(1)


# --- the models against the plain versions --------------------------------

@pytest.mark.parametrize("name", STREAMS)
def test_sweep_model_matches_the_plain_version(name):
    st = Stream(*stream(name))
    g, n, steps = sweep_model(st)
    gp, np_ = fk.fsm_sweep_plain(st.padded, torch.from_numpy(st.trans),
                                 st.total_bits, st.depth)
    assert torch.equal(g, gp) and torch.equal(n, np_)
    if st.depth <= fk.WINDOW_DEPTH:   # each distinct boundary decoded once
        assert steps.tolist() == [distinct_boundaries(st, c)
                                  for c in range(st.L)]
    if name == "never_syncs":         # D = 3 phases never meet
        assert (g[:-1].unique(dim=1).shape[1] == 3)
    print(f"{name}: D {st.depth}, F {st.F}, k {st.k}, chunks {st.L}, "
          f"K5 codeword steps a chunk mean {steps.mean():.1f} max "
          f"{steps.max()}, warp max mean {warp_max(steps).mean():.1f}")


@pytest.mark.parametrize("name", STREAMS)
def test_emit_model_matches_the_plain_version(name):
    st = Stream(*stream(name))
    g, n = fk.fsm_sweep_plain(st.padded, torch.from_numpy(st.trans),
                              st.total_bits, st.depth)
    entry, offsets, total = fk.fsm_scan(g, n)
    total = int(total)
    n_sym = max(total - 3, 0)           # drop the last symbols, as K7 may
    want = fk.fsm_emit_plain(st.padded, torch.from_numpy(st.trans),
                             st.total_bits, st.depth, entry, offsets, n_sym)
    got, steps, rounds = emit_model(st, entry, offsets, n_sym)
    assert torch.equal(got, want)
    assert steps.sum() >= total - (st.L - 1)   # a codeword a step
    print(f"{name}: K7 codeword steps a chunk mean {steps.mean():.1f}, "
          f"staged rounds a warp mean {rounds.mean():.2f} max "
          f"{rounds.max()}")


# --- script: the model on chip_smoke's streams ---------------------------

def _field_streams(n):
    """(name, (L, R, C, T, nodes), coded bytes, symbols) of the ABS 1e-3
    and PW_REL 1e-3 (|field|) streams of chip_smoke.field((n,)*3, 42),
    compressed by the port on the CPU."""
    import chip_smoke
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    from sz_tpu_torch.config import DataType
    from sz_tpu_torch.core import regnd
    from sz_tpu_torch.format import bytes_util as bu
    from sz_tpu_torch.format import lossless as ll
    from sz_tpu_torch.format import metadata as md
    from sz_tpu_torch.format import tdps as tdps_mod

    shape = (n, n, n)
    x = chip_smoke.field(shape, 42)
    out = []
    for mode, data in ((ErrorBoundMode.ABS, x),
                       (ErrorBoundMode.PW_REL, np.abs(x))):
        cfg = SZConfig().with_bound(mode, 1e-3)
        inner = ll.decompress(sz_tpu_torch.compress(data, cfg, device="cpu"),
                              x.nbytes + 64)
        hdr = md.parse_header(inner, DataType.FLOAT)
        body = memoryview(inner)[hdr.body_offset + hdr.size_type:]
        if mode == ErrorBoundMode.ABS:
            p = regnd.parse_body(
                bytes(body), shape, np.float32, hdr.size_type,
                lambda tree, enc, cnt: fk.decode(tree, enc, cnt,
                                                 "cpu")[0].numpy())
            tree, enc = p.tree, p.encoded
        else:
            ta = tdps_mod.from_bytes(body, DataType.FLOAT, is_pwr=True,
                                     msst19=True,
                                     size_type=hdr.size_type).type_array
            nc = bu.read_u32_be(ta, 0)
            tsize = huffman.tree_bytes_size(nc)
            tree = (*huffman.deserialize_tree(ta[8:8 + tsize], nc), nc)
            enc = bytes(ta[8 + tsize:])
        out.append((f"{mode.name} 1e-3", tree, enc, x.size))
    return out


def _code_lengths(tree):
    """Each symbol's code length (dict), by a walk of the tree."""
    L, R, C, T = tree[:4]
    lens, frontier, d = {}, [0], 0
    while frontier:
        d += 1
        nxt = []
        for s in frontier:
            for kid in (int(L[s]), int(R[s])):
                if T[kid]:
                    lens[int(C[kid])] = d
                else:
                    nxt.append(kid)
        frontier = nxt
    return lens


def main(n: int, sample: int = 4096) -> None:
    for name, tree, enc, nsym in _field_streams(n):
        st = Stream(tree[:4], enc)
        chunks = range(min(st.L, sample))
        _, _, steps = sweep_model(st, chunks)
        syms = fk.decode(tree, enc, nsym, "cpu")[0].numpy()
        lens = _code_lengths(tree)
        code_len = np.vectorize(lens.get)(syms)
        print(f"{n}^3 {name}: nodes {tree[4]}, D {st.depth}, "
              f"{st.total_bits / nsym:.2f} bits a symbol, {st.L} chunks, "
              f"{nsym / st.L:.1f} codewords a chunk; codes past 12 bits "
              f"{100 * (code_len > 12).mean():.2f} %, past 14 bits "
              f"{100 * (code_len > 14).mean():.2f} %; K5 model over the "
              f"first {len(chunks)} chunks: codeword steps a chunk mean "
              f"{steps.mean():.1f}, warp max mean "
              f"{warp_max(steps).mean():.1f}; the bit-level walk took >= "
              f"F + D = {st.F + st.depth} bit steps a chunk", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 128)
