"""The port's exchange wire (``repro_torch/core/alltoallv.py``) against the
JAX reference on identical inputs, on the CPU: codecs byte for byte, wire
layouts field by field, fuse/defuse round trips, ragged pack and unpack,
and the byte counters.  The collectives at P > 1 are held in
``tests/test_torch_exchange.py`` (gloo members); here a one-member gloo
group covers their P = 1 path.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alltoallv as ja2a
from repro_torch.core import alltoallv as ta2a
from repro_torch.launch import mesh

CODECS = ("float32", "bfloat16", "int8")


def _bytes(a) -> tuple:
    """(shape, raw bytes) of a torch tensor or a JAX/numpy array."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.contiguous().view(torch.uint8).numpy() \
            .tobytes()
    a = np.asarray(a)
    return a.shape, a.tobytes()


def _same(t, j, what=""):
    assert _bytes(t) == _bytes(j), what
    if isinstance(j, dict):
        raise TypeError(what)


def _codec_rows(case: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if case == "half_even_ties":
        # the row's max 7.875 gives a bf16 scale of exactly 2^-4, so
        # (n + 1/2) / 16 quantizes to a tie; 1 + 2^-8 and 1 + 3·2^-8 are
        # ties of the bf16 cast itself
        q = np.arange(-8, 8) + 0.5
        row = np.concatenate([[7.875, -7.875], q / 16.0,
                              [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)]])
        return np.stack([row, row[::-1]]).astype(np.float32)
    if case == "all_zero":
        x = rng.standard_normal((4, 24)).astype(np.float32)
        x[1] = 0.0
        x[3] = -0.0
        return x
    if case == "reaches_127":
        # entries of ±127 and rows whose extremes are equal and opposite
        x = rng.uniform(-1.0, 1.0, (5, 33)).astype(np.float32)
        x[:, 0] = np.abs(x).max(1) * 1.5
        x[::2, 1] = -x[::2, 0]
        x[1, :4] = [127.0, -127.0, 126.5, -0.5]
        return x
    # mixed magnitudes across rows
    return (rng.standard_normal((16, 3, 40)) *
            np.exp(rng.uniform(-30, 30, (16, 3, 1)))).astype(np.float32)


@pytest.mark.parametrize("codec", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", ["half_even_ties", "all_zero",
                                  "reaches_127", "mixed_magnitudes"])
def test_codecs_are_byte_identical(case, codec):
    x = _codec_rows(case)
    jp = ja2a.encode_wire(jnp.asarray(x), codec)
    tp = ta2a.encode_wire(torch.from_numpy(x), codec)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        _same(tp[k], jp[k], k)
    if codec == "int8":
        q = tp["q"].numpy()
        assert np.abs(q.astype(np.int32)).max() <= 127
        if case == "reaches_127":
            # the one-ulp nudge of the scale keeps every row's extreme at
            # 126, one step inside the clip
            assert (np.abs(q.astype(np.int32)).max(-1) == 126).all()
    _same(ta2a.decode_wire(tp), ja2a.decode_wire(jp), "decode")


def test_codec_spellings_and_float32_passthrough():
    for spelling in (None, "f32", "float32", "bf16", "bfloat16", "int8"):
        assert ta2a.canon_wire(spelling) == ja2a.canon_wire(spelling)
    with pytest.raises(ValueError):
        ta2a.canon_wire("fp8")
    x = torch.randn(3, 4)
    assert ta2a.encode_wire(x, "float32")["q"] is x
    assert ta2a.WIRE_SCALE_BYTES == ja2a.WIRE_SCALE_BYTES
    assert ta2a.WIRE_ITEMSIZE == ja2a.WIRE_ITEMSIZE


def _layouts(ragged, codec, riders, wire_check, **kw):
    extra = {"delta_bytes": 52, "mig_bytes": 36, "rep_bytes": 20} \
        if riders else {}
    args = dict(ragged=ragged, n_dest=3, cap=7, bs=5, t_loc=2, embed_dim=9,
                wire_dtype=codec, wire_check=wire_check, **extra)
    args.update(kw)
    return (ta2a.exchange_wire_layout(**args),
            ja2a.exchange_wire_layout(**args))


def _same_layout(tl, jl):
    assert (tl.n_dest, tl.slot_bytes, tl.names, tl.wire_bytes) == \
        (jl.n_dest, jl.slot_bytes, jl.names, jl.wire_bytes)
    assert [dataclasses.astuple(f) for f in tl.fields] == \
        [dataclasses.astuple(f) for f in jl.fields]
    for f in jl.fields:
        assert tl.field(f.name).nbytes == f.nbytes


@pytest.mark.parametrize("wire_check", [False, True])
@pytest.mark.parametrize("riders", [False, True])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("ragged", [False, True])
def test_exchange_layouts_match_field_by_field(ragged, codec, riders,
                                               wire_check):
    tl, jl = _layouts(ragged, codec, riders, wire_check)
    _same_layout(tl, jl)
    with pytest.raises(KeyError):
        tl.field("nope")


@pytest.mark.parametrize("name", ["delta", "mig", "rep"])
def test_rider_layouts_match_field_by_field(name):
    for cap, s in ((1, 4), (5, 16), (8, 64)):
        _same_layout(getattr(ta2a, f"{name}_wire_layout")(3, cap, s),
                     getattr(ja2a, f"{name}_wire_layout")(3, cap, s))


def test_slot_id_dtype_switches_above_2_15():
    for n, want in ((2 ** 15, torch.int16), (2 ** 15 + 1, torch.int32)):
        assert ta2a.slot_id_dtype(n) == want
        assert str(ta2a.slot_id_dtype(n)).removeprefix("torch.") == \
            str(jnp.dtype(ja2a.slot_id_dtype(n)))
        tl, jl = _layouts(True, "int8", False, False, n_slots=n)
        _same_layout(tl, jl)


def _payload(codec, ragged, rng):
    """A codec payload and its layout pair, as the exchange builds it."""
    p, cap, bs, t_loc, s = 3, 6, 4, 2, 8
    if ragged:
        x = rng.standard_normal((p, cap, s)).astype(np.float32)
        extra = {"ids": rng.integers(-2 ** 15, 2 ** 15, (p, cap))
                 .astype(np.int16),
                 "counts": rng.integers(0, cap + 1, (p, 1)).astype(np.int32)}
    else:
        x = rng.standard_normal((p, bs, t_loc, s)).astype(np.float32)
        extra = {}
    x.reshape(-1)[:3] = [np.nan, -0.0, np.inf] if codec == "float32" \
        else 0.0
    tl, jl = _layouts(ragged, codec, False, False, cap=cap, bs=bs,
                      t_loc=t_loc, embed_dim=s)
    tp = ta2a.encode_wire(torch.from_numpy(x), codec)
    jp = ja2a.encode_wire(jnp.asarray(x), codec)
    tp.update({k: torch.from_numpy(v) for k, v in extra.items()})
    jp.update({k: jnp.asarray(v) for k, v in extra.items()})
    return tp, jp, tl, jl


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("ragged", [False, True])
def test_fuse_defuse_round_trips(ragged, codec):
    tp, jp, tl, jl = _payload(codec, ragged, np.random.default_rng(5))
    tbuf = ta2a.fuse_wire(tp, tl)
    assert tbuf.dtype == torch.uint8 and tbuf.shape == (3, tl.slot_bytes)
    _same(tbuf, ja2a.fuse_wire(jp, jl), "fused")
    back = ta2a.defuse_wire(tbuf, tl)
    for k in tp:
        _same(back[k], tp[k], k)
    chunk = ta2a.defuse_wire(tbuf[2], tl)
    for k in tp:
        _same(chunk[k], tp[k][2], k)


def _tree(rng, n):
    return {"rows": rng.standard_normal((n, 5)).astype(np.float32),
            "ids": rng.integers(-300, 300, n).astype(np.int16),
            "idx": rng.integers(0, 1000, (n, 3)).astype(np.int32)}


def _same_pack(tout, jout):
    (tb, tc, td), (jb, jc, jd) = tout, jout
    for k in jb:
        _same(tb[k], jb[k], k)
    _same(tc, jc, "counts")
    assert int(td) == int(jd)


@pytest.mark.parametrize("cap", [1, 3, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_ragged_tree_is_bit_exact(seed, cap):
    rng = np.random.default_rng(seed)
    n, n_dest = 40, 4
    tree = _tree(rng, n)
    # -1 and n_dest mark excluded rows: never packed, never drops
    dest = rng.integers(-1, n_dest + 1, n).astype(np.int32)
    tout = ta2a.pack_ragged_tree({k: torch.from_numpy(v)
                                  for k, v in tree.items()},
                                 torch.from_numpy(dest), n_dest, cap)
    jout = ja2a.pack_ragged_tree({k: jnp.asarray(v) for k, v in tree.items()},
                                 jnp.asarray(dest), n_dest, cap)
    _same_pack(tout, jout)
    kept = ((dest >= 0) & (dest < n_dest)).sum()
    assert int(tout[1].sum()) + int(tout[2]) == kept
    if cap == 1:
        assert int(tout[2]) > 0
    single = ta2a.pack_ragged(torch.from_numpy(tree["rows"]),
                              torch.from_numpy(dest), n_dest, cap)
    _same(single[0], jout[0]["rows"], "pack_ragged")


@pytest.mark.parametrize("cap", [1, 4, 10, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_ragged_segments_is_bit_exact(seed, cap):
    rng = np.random.default_rng(seed)
    n_dest, per = 4, 10
    tree = _tree(rng, n_dest * per)
    live = rng.random(n_dest * per) < 0.6
    live[:per] = True                  # one full segment: drops at cap < 10
    tout = ta2a.pack_ragged_segments({k: torch.from_numpy(v)
                                      for k, v in tree.items()},
                                     torch.from_numpy(live), n_dest, cap)
    jout = ja2a.pack_ragged_segments({k: jnp.asarray(v)
                                      for k, v in tree.items()},
                                     jnp.asarray(live), n_dest, cap)
    _same_pack(tout, jout)
    assert int(tout[1].sum()) + int(tout[2]) == live.sum()
    assert (int(tout[2]) > 0) == (cap < per)


def test_unpack_ragged_drops_stale_and_out_of_range_slots():
    rng = np.random.default_rng(7)
    p, cap, n_slots, d = 3, 6, 40, 4
    rows = rng.standard_normal((p, cap, d)).astype(np.float32)
    counts = np.array([4, 0, 6], np.int32)
    # valid slots are distinct; -1 counts from the end, 45 lies past it;
    # entries beyond each count are stale and may name anything
    slots = rng.integers(-50, 50, (p, cap)).astype(np.int32)
    slots[0, :4] = [3, 17, -1, 45]
    slots[2] = [0, 5, 9, 11, 30, 38]
    got = ta2a.unpack_ragged(torch.from_numpy(rows), torch.from_numpy(slots),
                             torch.from_numpy(counts), n_slots)
    want = ja2a.unpack_ragged(jnp.asarray(rows), jnp.asarray(slots),
                              jnp.asarray(counts), n_slots)
    _same(got, want, "unpack")
    assert got.shape == (n_slots, d)
    assert torch.equal(got[n_slots - 1], torch.from_numpy(rows[0, 2]))
    assert int((got.abs().sum(1) > 0).sum()) == 3 + 6


@pytest.mark.parametrize("codec", CODECS)
def test_byte_counters_match(codec):
    rng = np.random.default_rng(9)
    miss = (rng.random((12, 5, 4)) < 0.3).astype(np.float32)
    assert dataclasses.asdict(ta2a.wire_stats(torch.from_numpy(miss), 16,
                                              codec)) == \
        dataclasses.asdict(ja2a.wire_stats(jnp.asarray(miss), 16, codec))
    assert ta2a.wire_stats(miss, 16, codec).reduction_vs_ref == \
        ja2a.wire_stats(miss, 16, codec).reduction_vs_ref
    for p, cap, n_slots in ((1, 4, 8), (4, 37, 2 ** 15 + 3), (8, 1, 100)):
        assert ta2a.ragged_wire_bytes(p, cap, 64, codec, n_slots=n_slots) \
            == ja2a.ragged_wire_bytes(p, cap, 64, codec, n_slots=n_slots)
        assert ta2a.dense_wire_bytes(p, 3, cap, 64, codec) == \
            ja2a.dense_wire_bytes(p, 3, cap, 64, codec)
    counts = np.array([3, 0, 7, 2], np.int32)
    for slot_bytes in (0, 1000):
        assert dataclasses.asdict(ta2a.dispatch_stats(
            torch.from_numpy(counts), 8, 68, slot_bytes)) == \
            dataclasses.asdict(ja2a.dispatch_stats(jnp.asarray(counts), 8, 68,
                                                   slot_bytes))


def test_one_member_collectives(tmp_path):
    """On a one-member gloo group the collectives hand back what was sent:
    the butterfly is the codec's round trip, the ragged exchange and the
    ring give the send buffers, and the ring consumes the own chunk
    once."""
    mesh.init_model_group("gloo", 1, 0, f"file://{tmp_path / 'store'}")
    try:
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (4, 3, 8)).astype(np.float32))
        for codec in CODECS:
            want = ta2a.decode_wire(ta2a.encode_wire(x, codec))
            assert torch.equal(ta2a.butterfly_pooled(x, wire_dtype=codec),
                               want)
        payload = {"rows": x[None], "ids": torch.arange(4,
                                                        dtype=torch.int16)[None]}
        recv, cnt = ta2a.alltoallv_ragged(payload, torch.tensor([4],
                                                                dtype=torch.int32))
        assert torch.equal(recv["rows"], payload["rows"])
        assert torch.equal(recv["ids"], payload["ids"]) and cnt.tolist() == [4]
        raw, _ = ta2a.alltoallv_raw(x[None], torch.tensor([4], dtype=torch.int32))
        assert torch.equal(raw, x[None])
        buf = torch.arange(12, dtype=torch.uint8).reshape(1, 12)
        seen = ta2a.ring_exchange(buf, None, 1,
                                  lambda acc, src, chunk: acc + [(src, chunk)],
                                  [])
        assert len(seen) == 1 and seen[0][0] == 0
        assert torch.equal(seen[0][1], buf[0])
        assert torch.equal(ta2a.alltoallv_fused(buf).wait(), buf)
    finally:
        mesh.destroy_model_group()
