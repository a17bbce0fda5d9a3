"""Board geometry tests, mirroring the reference's
``tests/board_test.rs:4-40``."""

import numpy as np

from ccrs_jax.board import Board, BoardConfig, create_default_6x6_board


def test_board_init():
    board = Board.from_config(BoardConfig())
    assert board.n_corners == 6 * 6 * 4

    s = 0.088
    p0, p1, p2, p3 = board.p3d[0], board.p3d[1], board.p3d[2], board.p3d[3]
    assert abs(p0[0] - 0.0) < 1e-6 and abs(p0[1] - 0.0) < 1e-6
    assert abs(p1[0] - s) < 1e-6 and abs(p1[1] - 0.0) < 1e-6
    assert abs(p2[0] - s) < 1e-6 and abs(p2[1] + s) < 1e-6
    assert abs(p3[0] - 0.0) < 1e-6 and abs(p3[1] + s) < 1e-6
    assert np.all(board.p3d[:, 2] == 0.0)


def test_board_second_row_and_col():
    board = create_default_6x6_board()
    pitch = 0.088 * 1.3
    # tag 1 = row 0, col 1 -> TL at (pitch, 0)
    assert abs(board.p3d[4][0] - pitch) < 1e-6
    assert abs(board.p3d[4][1]) < 1e-6
    # tag 6 = row 1, col 0 -> TL at (0, -pitch)
    assert abs(board.p3d[24][0]) < 1e-6
    assert abs(board.p3d[24][1] + pitch) < 1e-6


def test_corner_index_mapping():
    board = Board(BoardConfig(first_id=3))
    ids = np.array([12, 13, 12 + board.n_corners, 0])
    idx = board.corner_index(ids)
    assert idx[0] == 0 and idx[1] == 1
    assert idx[2] == -1  # beyond board
    assert idx[3] == -1  # below first id
