"""The port's database layer against the JAX package's: the 6-file format
byte for byte, the pseudo DB, the bucket plan and the packed tiles.

Tolerance: exact — every compared object is bytes or integer arrays.
"""

import gzip

import numpy as np
import pytest

import chip_smoke
import cudasw4_tpu.db.format as jf
import cudasw4_tpu.db.packing as jp
import cudasw4_tpu.db.pseudo as jps
import cudasw4_tpu_torch.db.format as tf
import cudasw4_tpu_torch.db.packing as tp
import cudasw4_tpu_torch.db.pseudo as tps

DB_FILES = ["metadata", "0chars", "0offsets", "0lengths", "0headers",
            "0headeroffsets", "0metadata"]


def _write_fasta(path, rng, n=300):
    """Records with ragged lengths, lower-case and ambiguity letters,
    multi-line sequences, blank lines and spaces in headers."""
    letters = np.frombuffer(b"ARNDCQEGHILKMFPSTWYVBJZX*acdu", dtype=np.uint8)
    with open(path, "w") as f:
        for i in range(n):
            ln = int(rng.integers(0, 140))
            seq = letters[rng.integers(0, len(letters), size=ln)].tobytes().decode()
            f.write(f">rec{i} some description {ln}\n")
            for s in range(0, ln, 60):
                f.write(seq[s : s + 60] + "\n")
            if i % 7 == 0:
                f.write("\n")


def _read(prefix, name):
    with open(prefix + name, "rb") as f:
        return f.read()


@pytest.mark.parametrize("gz", [False, True])
def test_makedb_files_byte_identical(tmp_path, gz):
    rng = np.random.default_rng(41)
    fasta = str(tmp_path / "db.fa")
    _write_fasta(fasta, rng)
    if gz:
        with open(fasta, "rb") as src, gzip.open(fasta + ".gz", "wb") as dst:
            dst.write(src.read())
        fasta += ".gz"
    jpre, tpre, cpre = (str(tmp_path / p) for p in ("jax_", "port_", "capped_"))
    jstats = jf.make_db(fasta, jpre)
    tstats = tf.make_db(fasta, tpre)
    cstats = tf.make_db_capped(fasta, cpre, mem_limit=1 << 20, tempdir=str(tmp_path))
    assert jstats == tstats == cstats
    for name in DB_FILES:
        want = _read(jpre, name)
        assert _read(tpre, name) == want, name
        assert _read(cpre, name) == want, name


def test_load_db_reads_each_others_files(tmp_path):
    rng = np.random.default_rng(42)
    fasta = str(tmp_path / "db.fa")
    _write_fasta(fasta, rng, n=80)
    jf.make_db(fasta, str(tmp_path / "j_"))
    tf.make_db(fasta, str(tmp_path / "t_"))
    for a, b in ((tf.load_db(str(tmp_path / "j_")), jf.load_db(str(tmp_path / "t_"))),
                 (tf.load_db(str(tmp_path / "t_"), mmap=False), jf.load_db(str(tmp_path / "j_")))):
        for field in ("chars", "offsets", "lengths", "headers", "header_offsets"):
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
        assert [a.get_header(i) for i in range(5)] == [b.get_header(i) for i in range(5)]
    with pytest.raises(tf.LoadDBError):
        tf.load_db(str(tmp_path / "missing_"))


def test_pseudo_db_identical():
    j, t = jps.make_pseudo_db(9, 37, seed=5), tps.make_pseudo_db(9, 37, seed=5)
    for field in ("chars", "offsets", "lengths"):
        assert np.array_equal(getattr(t, field), getattr(j, field)), field
    assert t.headers == j.headers
    jg, tg = jps.MT19937(42), tps.MT19937(42)
    assert [tg.next_u32() for _ in range(700)] == [jg.next_u32() for _ in range(700)]
    jd, td = jf.pseudo_to_dbdata(j), tf.pseudo_to_dbdata(t)
    assert np.array_equal(td.header_offsets, jd.header_offsets)
    assert np.array_equal(td.headers, jd.headers)


def _three_kind_lengths(rng):
    """~4k sorted lengths that pack into row (<= 32), cell (one short
    edge, 2.5k sequences) and col (1.5k of 800..896 aa) buckets."""
    return np.sort(np.concatenate([
        rng.integers(5, 33, size=60),
        rng.integers(33, 49, size=2500),
        rng.integers(800, 897, size=1500),
    ]))


#: Swiss-Prot-scale plans: longest sequence, top col bucket's L, padded chars.
SPROT_PLANS = {
    "sprot_chip_smoke": (5599, 5632, 254_486_528),
    "sprot_one_draw": (7196, 7680, 262_875_136),
}


@pytest.mark.parametrize("case", ["small", "three_kind", "sprot_like", "adaptive", *SPROT_PLANS])
def test_plan_buckets_identical(case):
    """Both packages' bucket plans, exact.  The Swiss-Prot-scale cases are
    chip_smoke.py's 573k lengths, drawn chunk by chunk as
    benchmarks/make_synthetic_db.py draws them, and the same model drawn
    in one call: 23 buckets either way, but the draw order changes the
    longest sequence, and with it the top col bucket's L and the padded
    size."""
    rng = np.random.default_rng(43)
    if case == "small":
        lengths = np.sort(rng.integers(1, 3000, size=500))
    elif case == "three_kind":
        lengths = _three_kind_lengths(rng)
    elif case == "sprot_like":
        lengths = np.sort(np.clip(rng.lognormal(np.log(292), 0.64, 57_300), 11, 35000).astype(np.int64))
    elif case == "sprot_chip_smoke":
        lengths = np.sort(np.concatenate([lens for _, lens, _ in chip_smoke.sprot_chunks()]))
    elif case == "sprot_one_draw":
        draw = np.random.default_rng(42).lognormal(np.log(292.0), 0.64, 573_000)
        lengths = np.sort(np.clip(draw, 11, 35000).astype(np.int64))
    else:  # >= 2M sequences switch to 16-step edges
        lengths = np.sort(np.clip(rng.lognormal(np.log(220), 0.75, 2_000_000), 11, 35000).astype(np.int64))
    tplan = tp.plan_buckets(lengths)
    assert tplan == jp.plan_buckets(lengths)
    assert {k for *_, k in tplan} >= ({"row", "cell", "col"} if case != "small" else {"row"})
    if case in SPROT_PLANS:
        kinds = [k for *_, k in tplan]
        assert (kinds.count("row"), kinds.count("cell"), kinds.count("col")) == (2, 15, 6)
        padded = sum(-(-(b - a) // ns) * ns * L for a, b, L, ns, _ in tplan)
        assert (int(lengths[-1]), tplan[-1][2], padded) == SPROT_PLANS[case]


def _db_from_lengths(rng, lengths):
    pads = (lengths + 3) // 4 * 4
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(pads, out=offsets[1:])
    chars = rng.integers(0, 21, size=int(offsets[-1])).astype(np.int8)
    for i, (a, ln) in enumerate(zip(offsets[:-1], lengths)):
        chars[a + ln : offsets[i + 1]] = 20  # on-disk padding is UNKNOWN
    return tf.DBData(chars=chars, offsets=offsets.astype(np.uint64),
                     lengths=lengths.astype(np.int32),
                     headers=np.zeros(0, np.uint8),
                     header_offsets=np.zeros(len(lengths) + 1, np.uint64))


@pytest.mark.parametrize("pad_code", [20, 25])
def test_pack_db_identical_three_kinds(pad_code):
    rng = np.random.default_rng(44)
    db = _db_from_lengths(rng, _three_kind_lengths(rng))
    jpk = jp.pack_db(db, pad_code=pad_code)
    tpk = tp.pack_db(db, pad_code=pad_code)
    assert [b.kernel for b in tpk.buckets] == ["row", "cell", "col"]
    assert (tpk.num_sequences, tpk.total_real_chars, tpk.total_padded_chars) == (
        jpk.num_sequences, jpk.total_real_chars, jpk.total_padded_chars)
    assert len(tpk.buckets) == len(jpk.buckets)
    for t, j in zip(tpk.buckets, jpk.buckets):
        assert (t.L, t.NS, t.kernel, t.is_long) == (j.L, j.NS, j.kernel, j.is_long)
        assert t.tiles.shape == j.tiles.shape
        assert np.array_equal(t.tiles, np.asarray(j.tiles))
        assert np.array_equal(t.seq_index, j.seq_index)
        assert np.array_equal(t.lengths, j.lengths)
    carried = tp.packed_from_arrays(
        [dict(L=b.L, NS=b.NS, kernel=b.kernel, tiles=b.tiles,
              seq_index=b.seq_index, lengths=b.lengths) for b in jpk.buckets],
        jpk.num_sequences, jpk.total_real_chars,
    )
    for t, c in zip(tpk.buckets, carried.buckets):
        assert np.array_equal(t.tiles, c.tiles) and t.kernel == c.kernel


def test_pack_db_rejects_unsorted():
    rng = np.random.default_rng(45)
    db = _db_from_lengths(rng, np.array([5, 3, 9]))
    with pytest.raises(ValueError):
        tp.pack_db(db)


def test_ladder_and_layout_helpers_identical():
    for n in (1, 100, 769, 4096, 4097, 16384, 16385, 40000):
        assert tp.ladder_length(n) == jp.ladder_length(n)
        assert tp.bucket_length_for(n) == jp.bucket_length_for(n)
    for L in (32, 768, 896, 2304, 2400):
        for count in (1, 200, 1500, 2400, 5000):
            assert tp.choose_bucket_layout(L, count) == jp.choose_bucket_layout(L, count)
    assert tp.adaptive_edges(10) is jp.adaptive_edges(10) is None
    assert tp.adaptive_edges(2_000_000) == jp.adaptive_edges(2_000_000)
