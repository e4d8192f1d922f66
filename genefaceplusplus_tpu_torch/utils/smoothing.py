"""Pose-schedule looping (copy of `mirror_index` in
`genefaceplusplus_tpu/utils/smoothing.py`)."""


def mirror_index(index: int, size: int) -> int:
    """Ping-pong looping: 0,1,...,n-1,n-2,...,1,0,1,... for driving poses."""
    turn = index // (size - 1) if size > 1 else 0
    res = index % (size - 1) if size > 1 else 0
    return res if turn % 2 == 0 else size - 1 - res
