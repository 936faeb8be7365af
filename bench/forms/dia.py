"""The operator handed to the program in DIA form: the band as it is."""
from __future__ import annotations


def build(offsets, data):
    from repro_torch.sparse import DIAMatrix

    return DIAMatrix(data, tuple(int(o) for o in offsets), int(data.shape[1]))


def stored_bytes(offsets, n: int) -> int:
    """Bytes of the float32 band: one value per diagonal and row."""
    return len(offsets) * n * 4
