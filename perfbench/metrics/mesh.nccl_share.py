"""``mesh.nccl_share``: the share of rank 0's traced window in which an
NCCL kernel runs, in %; None on one chip or without one."""


def read(rc):
    if rc.world < 2:
        return None
    return rc.timeline.share("nccl")
