"""Tag family table tests."""

import numpy as np
import pytest

from ccrs_jax.detect.families import get_family


def test_t36h11_table():
    fam = get_family("t36h11")
    assert fam.n_codes == 587
    assert fam.size == 6
    assert fam.border == 2
    rc = fam.rotated_codes
    assert rc.shape == (587 * 4, 36)
    assert set(np.unique(rc)) == {-1, 1}
    # all rotations of all codes distinct (family property)
    assert len({tuple(r) for r in rc}) == 587 * 4


def test_t36h11b1_shares_codes():
    a = get_family("t36h11")
    b = get_family("t36h11b1")
    assert np.array_equal(a.codes, b.codes)
    assert b.border == 1


def test_small_families():
    assert get_family("t16h5").n_codes == 30
    assert get_family("t25h9").n_codes == 35


def test_t25h7_unavailable():
    # t25h7 is intentionally NOT advertised (its canonical table cannot be
    # regenerated offline; see detect/families.py) and must fail loudly
    # with a pointer to the custom-TagFamily escape hatch.
    from ccrs_jax.detect.families import FAMILY_NAMES

    assert "t25h7" not in FAMILY_NAMES
    with pytest.raises(ValueError, match="t25h7"):
        get_family("t25h7")


def test_family_from_table_bits(tmp_path):
    """CLI escape hatch (r02 verdict #5): a user-supplied npz code table
    constructs a working family under the t25h7 name."""
    from ccrs_jax.detect.families import family_from_table

    base = get_family("t25h9")  # stand-in 5x5 codes for the table format
    p = tmp_path / "table.npz"
    np.savez(p, codes=base.codes, size=np.int32(5), border=np.int32(2),
             max_hamming=np.int32(1))
    fam = family_from_table("t25h7", str(p))
    assert fam.name == "t25h7"
    assert fam.size == 5 and fam.border == 2 and fam.max_hamming == 1
    assert np.array_equal(fam.codes, base.codes)


def test_family_from_table_packed(tmp_path):
    """Packed-uint64 tables (upstream apriltag codes[] convention: MSB of
    the size^2-bit word = cell 0) unpack to the same cell bits."""
    from ccrs_jax.detect.families import family_from_table

    base = get_family("t25h9")
    nbits = base.size * base.size
    packed = np.zeros(base.n_codes, np.uint64)
    for i, row in enumerate(base.codes):
        v = 0
        for b in row:
            v = (v << 1) | int(b)
        packed[i] = v
    p = tmp_path / "packed.npz"
    np.savez(p, codes=packed, size=np.int32(5))
    fam = family_from_table("t25h7", str(p))
    assert np.array_equal(fam.codes, base.codes)
    assert nbits == 25


def test_cli_accepts_t25h7_with_table(tmp_path):
    """`--tag-family t25h7 --tag-family-table ...` reaches detector
    construction (parity with bin/camera_calibration.rs:31-33)."""
    from ccrs_jax.cli import build_parser
    from ccrs_jax.detect.families import family_from_table

    base = get_family("t25h9")
    p = tmp_path / "t.npz"
    np.savez(p, codes=base.codes, size=np.int32(5))
    args = build_parser().parse_args(
        ["/nonexistent", "--tag-family", "t25h7", "--tag-family-table", str(p)]
    )
    fam = family_from_table(args.tag_family, args.tag_family_table)
    from ccrs_jax.detect import TagDetector

    det = TagDetector(fam)
    assert det.family.name == "t25h7"
