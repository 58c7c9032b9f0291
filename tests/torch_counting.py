"""A MeshCommunication that counts its collectives, shared by the port's
tests that check a schedule (tests/test_torch_*.py)."""

import collections

from heat_tpu_torch.core.communication import MeshCommunication


class CountingMesh(MeshCommunication):
    """A mesh over ``devices`` that counts its collectives by verb in
    ``calls``."""

    def __init__(self, devices):
        super().__init__(devices)
        self.calls = collections.Counter()

    def allreduce(self, shards, op="sum"):
        self.calls["allreduce"] += 1
        return super().allreduce(shards, op)

    def allgather(self, shards, dim=0):
        self.calls["allgather"] += 1
        return super().allgather(shards, dim)

    def bcast(self, shards, root=0):
        self.calls["bcast"] += 1
        return super().bcast(shards, root)

    def ppermute(self, shards, shift=1, perm=None):
        self.calls["ppermute"] += 1
        return super().ppermute(shards, shift, perm)

    def alltoall(self, shards, split_axis=0, concat_axis=0):
        self.calls["alltoall"] += 1
        return super().alltoall(shards, split_axis, concat_axis)
