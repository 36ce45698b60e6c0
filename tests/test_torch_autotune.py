"""The port's per-geometry autotune table (serving.buckets) held against
repro.serving.buckets' table.

geometry_key and resolve_autotune equal JAX's on hypothesis-drawn
tables and buckets, on JAX's tile keys and on entries that carry other
keys beside them (which both chains pass on as they are). Each step of
the lookup chain returns what JAX's does, and a table file saved by
either package loads in the other. Nothing in the port applies an
entry: the CUDA kernels take no tiles, and their launch parameters are
picked by the wrappers from the launch's shape.
"""

import os
import tempfile

import pytest
from hypothesis import given, settings, strategies as st

import repro.serving.buckets as jb
from repro_torch.serving import resolve_autotune
from repro_torch.serving import buckets as tb

M1S = st.sampled_from((128, 192, 256, 384, 512, 1024, 2048, 4096))
M2S = st.sampled_from((8, 16, 32, 64, 128))
KS = st.sampled_from((4, 8, 16, 32))
BS = st.sampled_from((4, 8, 16, 32))
DS = st.one_of(st.none(), st.sampled_from((10, 16, 20, 50, 256)))


def _pair(m1, m2, K, B, tag="arch"):
    m2 = min(m2, m1)
    return (jb.Bucket(tag=tag, m1=m1, m2=m2, K=K, batch=B),
            tb.Bucket(tag=tag, m1=m1, m2=m2, K=K, batch=B))


JAX_ENTRY = st.fixed_dictionaries({
    "tile_b": st.sampled_from((4, 8, 16, 32)),
    "tile_m": st.sampled_from((128, 256, 512)),
    "tile_n": st.sampled_from((256, 512)),
    "quant": st.sampled_from(("off", "int8", "bf16"))})
# keys neither engine reads (a later knob, another backend's)
OTHER_ENTRY = st.dictionaries(
    st.sampled_from(("db_slab", "split", "chunk", "note")),
    st.one_of(st.integers(1, 1 << 16), st.text(max_size=4)), max_size=3)


def _table(draw_entries, geoms, ds):
    table = {}
    for (m1, m2, K, B), d, entry in zip(geoms, ds, draw_entries):
        _, bucket = _pair(m1, m2, K, B)
        table[tb.geometry_key(bucket, d_cov=d)] = entry
    return table


GEOMS = st.lists(st.tuples(M1S, M2S, KS, BS), min_size=0, max_size=6)


@settings(max_examples=60, deadline=None)
@given(st.tuples(M1S, M2S, KS, BS), DS)
def test_geometry_key_matches_jax(geom, d):
    jbk, tbk = _pair(*geom)
    assert tb.geometry_key(tbk, d_cov=d) == jb.geometry_key(jbk, d_cov=d)
    assert tb.geometry_key(tbk) == jb.geometry_key(jbk)


@settings(max_examples=80, deadline=None)
@given(st.data())
def test_resolve_autotune_matches_jax_on_tile_keys(data):
    geoms = data.draw(GEOMS)
    ds = [data.draw(DS) for _ in geoms]
    entries = [data.draw(JAX_ENTRY) for _ in geoms]
    table = _table(entries, geoms, ds)
    jbk, tbk = _pair(*data.draw(st.tuples(M1S, M2S, KS, BS)))
    d = data.draw(DS)
    assert resolve_autotune(table, tbk, d_cov=d) == \
        jb.resolve_autotune(table, jbk, d_cov=d)


@settings(max_examples=80, deadline=None)
@given(st.data())
def test_resolve_autotune_matches_jax_on_other_keys(data):
    """Keys beside JAX's tiles pass through both chains unchanged."""
    geoms = data.draw(GEOMS)
    ds = [data.draw(DS) for _ in geoms]
    entries = [{**data.draw(OTHER_ENTRY), **data.draw(JAX_ENTRY)}
               for _ in geoms]
    table = _table(entries, geoms, ds)
    jbk, tbk = _pair(*data.draw(st.tuples(M1S, M2S, KS, BS)))
    d = data.draw(DS)
    assert resolve_autotune(table, tbk, d_cov=d) == \
        jb.resolve_autotune(table, jbk, d_cov=d)


# one case for each step of the chain, and for a miss
CHAIN = {
    "exact_with_d": ({"m1=1024/m2=64/K=8/B=32/d=20": {"tile_b": 8},
                      "m1=1024/m2=64/K=8/B=32": {"tile_b": 16}},
                     (1024, 64, 8, 32), 20, {"tile_b": 8}),
    "legacy_without_d": ({"m1=1024/m2=64/K=8/B=32": {"tile_b": 16}},
                         (1024, 64, 8, 32), 20, {"tile_b": 16}),
    "nearest_cover_clamped": ({"m1=2048/m2=64/K=8/B=32/d=20": {
                                   "tile_b": 64, "tile_m": 512}},
                              (384, 16, 4, 32), 20,
                              {"tile_b": 32, "tile_m": 384}),
    "cheapest_cover": ({"m1=4096/m2=128/K=32/B=8": {"tile_m": 128},
                        "m1=512/m2=64/K=8/B=8": {"tile_m": 256}},
                       (512, 8, 4, 8), None, {"tile_m": 256}),
    "other_batch_misses": ({"m1=2048/m2=64/K=8/B=32": {"tile_b": 8}},
                           (1024, 64, 8, 16), None, {}),
    "smaller_misses": ({"m1=256/m2=64/K=8/B=32": {"tile_b": 8}},
                       (1024, 64, 8, 32), None, {}),
    "empty": ({}, (128, 8, 4, 8), 16, {}),
}


@pytest.mark.parametrize("case", sorted(CHAIN))
def test_lookup_chain_step_matches_jax(case):
    table, geom, d, want = CHAIN[case]
    jbk, tbk = _pair(*geom)
    got = resolve_autotune(table, tbk, d_cov=d)
    assert got == want == jb.resolve_autotune(table, jbk, d_cov=d)
    if got:                        # a copy: the table stays as it was
        got["tile_b"] = -1
        assert resolve_autotune(table, tbk, d_cov=d) == want


def test_table_constants_match_jax():
    assert tb.DEFAULT_AUTOTUNE_PATH == jb.DEFAULT_AUTOTUNE_PATH
    assert tb.AUTOTUNE_KEYS == jb.AUTOTUNE_KEYS


def test_table_files_load_in_either_package():
    table = {"m1=1024/m2=64/K=8/B=32/d=20": {
                 "quant": "off", "tile_b": 8, "tile_m": 256, "tile_n": 512},
             "m1=256/m2=16/K=8/B=32": {"tile_b": 32, "tile_m": 256,
                                       "tile_n": 256, "quant": "int8"}}
    with tempfile.TemporaryDirectory() as d:
        p_t = tb.save_autotune_table(table, os.path.join(d, "a", "t.json"))
        p_j = jb.save_autotune_table(table, os.path.join(d, "j.json"))
        with open(p_t) as f1, open(p_j) as f2:
            assert f1.read() == f2.read()            # the same bytes
        assert jb.load_autotune_table(p_t) == table
        assert tb.load_autotune_table(p_j) == table
        assert tb.load_autotune_table(os.path.join(d, "none.json")) == \
            jb.load_autotune_table(os.path.join(d, "none.json")) == {}
