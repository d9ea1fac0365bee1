"""The card wire's protocol (distributed/card_wire.py) against gloo.

On the card it carries the gathers and sums of one card's gloo ranks
through buffers shared by CUDA IPC.  Its protocol (two buffers a rank
and group, one barrier a collective, messages in pieces, buffers grown
for every rank at once and released between phases) runs the same on
host tensors shared through the "file_system" strategy, so one spawn of
4 gloo CPU ranks holds it to gloo's own all-gather and to the sum of the
gathered tensors in group-rank order, bit for bit, on the whole group and
on both lines of a (2, 2) mesh, with pieces of 1 KiB (messages of up to
8 pieces) and of 64 MiB (every message one piece, one of them growing
the buffers).
"""
import torch_cores  # noqa: F401  (first: caps torch's threads)
import pytest

import torch_sharded_ranks as tsr
from repro_torch.distributed import ranks

CHUNKS = (1 << 10, 64 << 20)


@pytest.fixture(scope="module")
def wire_gaps():
    return ranks.run(tsr.card_wire_cases, 4, CHUNKS, device="cpu")


@pytest.mark.parametrize("chunk_bytes", CHUNKS)
def test_card_wire_gathers_and_sums_as_gloo(wire_gaps, chunk_bytes):
    for gaps in wire_gaps:
        assert gaps[chunk_bytes] == {"gather": 0.0, "sum": 0.0}
