"""heat_tpu_torch's tiling (``SplitTiles``, ``SquareDiagTiles``) and
printing (``set_printoptions``/``get_printoptions``,
``local_printing``/``global_printing``, ``print0`` and the string of an
array) against heat_tpu on the CPU mesh. Cases from test_tiling_parity.py.
Exact: tiles are index arithmetic, and the printed bodies are numpy's."""

import numpy as np
import pytest

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core.tiling import SplitTiles as RefSplitTiles
from heat_tpu.core.tiling import SquareDiagTiles as RefSquareDiagTiles
from test_torch_parity import P, both, data, on_cpu  # noqa: F401


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(8, 5), (13, 7), (3, 19)], ids=str)
def test_split_tiles_match_the_reference(shape, split):
    values = data(shape, "float32")
    theirs, mine = both(values, split)
    st, rt = ht.SplitTiles(mine), RefSplitTiles(theirs)
    np.testing.assert_array_equal(st.tile_dimensions, rt.tile_dimensions)
    np.testing.assert_array_equal(st.tile_ends_g, rt.tile_ends_g)
    np.testing.assert_array_equal(st.tile_locations, rt.tile_locations)
    np.testing.assert_array_equal(st.lshape_map, rt.lshape_map)
    for key in ((0, 0), (P - 1, 0), (slice(None), 0), (0, slice(1, None)), 0):
        assert st.get_tile_size(key) == rt.get_tile_size(key)
        np.testing.assert_array_equal(np.asarray(st[key]), np.asarray(rt[key]))
    tile = np.asarray(st[0, 0])
    st[0, 0] = np.zeros_like(tile)
    expected = values.copy()
    expected[: tile.shape[0], : tile.shape[1]] = 0
    np.testing.assert_array_equal(mine.numpy(), expected)


@pytest.mark.parametrize("tiles_per_proc", [1, 2])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(16, 8), (8, 16), (13, 7)], ids=str)
def test_square_diag_tiles_match_the_reference(shape, split, tiles_per_proc):
    values = data(shape, "float64")
    theirs, mine = both(values, split)
    sq, rq = ht.SquareDiagTiles(mine, tiles_per_proc), RefSquareDiagTiles(theirs, tiles_per_proc)
    for name in ("row_indices", "col_indices", "tile_rows", "tile_columns", "last_diagonal_process",
                 "tile_rows_per_process", "tile_columns_per_process", "tiles_per_proc"):
        assert getattr(sq, name) == getattr(rq, name), name
    np.testing.assert_array_equal(sq.tile_map, rq.tile_map)
    assert sq.get_start_stop((0, 0)) == rq.get_start_stop((0, 0))
    np.testing.assert_array_equal(np.asarray(sq.local_get((0, slice(None)))), np.asarray(rq.local_get((0, slice(None)))))
    r0, r1, c0, c1 = sq.get_start_stop((0, 0))
    sq.local_set((0, 0), np.zeros((r1 - r0, c1 - c0)))
    assert np.asarray(sq[0, 0]).sum() == 0
    assert sq.local_to_global((1, 0)) == (1, 0)
    other = ht.SquareDiagTiles(ht.array(data((shape[0], shape[0]), "float64"), split=split), tiles_per_proc)
    other_ref = RefSquareDiagTiles(ref.array(data((shape[0], shape[0]), "float64"), split=split), tiles_per_proc)
    sq.match_tiles(other)
    rq.match_tiles(other_ref)
    assert sq.row_indices == rq.row_indices and sq.col_indices == rq.col_indices
    np.testing.assert_array_equal(sq.tile_map, rq.tile_map)


def test_tiles_validate():
    with pytest.raises(ValueError):
        ht.SquareDiagTiles(ht.zeros((4,)), 1)
    with pytest.raises(ValueError):
        ht.SquareDiagTiles(ht.zeros((4, 4)), 0)


def _body(text: str) -> str:
    return text[len("DNDarray("): text.rindex(", dtype=")]


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("shape", [(5,), (4, 3), (70_000,), (300, 300)], ids=str)
def test_printing_matches_the_reference(shape, split):
    values = data(shape, "float32")
    theirs, mine = both(values, split)
    text = str(mine)
    assert text == repr(mine)
    assert _body(text) == _body(str(theirs))
    assert text.endswith(f", dtype=ht.float32, device=cpu, split={split})")


def test_print_options_and_modes(capsys):
    before = ht.get_printoptions()
    try:
        ht.set_printoptions(precision=2, edgeitems=1)
        ref.set_printoptions(precision=2, edgeitems=1)
        assert ht.get_printoptions() == ref.get_printoptions()
        values = data((2000,), "float64")
        theirs, mine = both(values, 0)
        assert _body(str(mine)) == _body(str(theirs))
        for profile in ("short", "full", "default"):
            ht.set_printoptions(profile=profile)
            ref.set_printoptions(profile=profile)
            assert ht.get_printoptions() == ref.get_printoptions()
        ht.local_printing()
        local = str(ht.array(np.arange(2 * P, dtype=np.int64), split=0))
        assert local.count("\n") == P - 1
        ht.global_printing()
        assert "\n" not in str(ht.array(np.arange(2 * P, dtype=np.int64), split=0))
        ht.print0("once")
        assert capsys.readouterr().out == "once\n"
    finally:
        ht.global_printing()
        ht.set_printoptions(**{k: v for k, v in before.items() if k != "sci_mode"})
        ref.set_printoptions(profile="default")
