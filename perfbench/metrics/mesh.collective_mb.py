"""``mesh.collective_mb``: the bytes of rank 0's collectives (the
``nbytes`` of the program's ``glabc.mesh.gather`` spans, the gathered
output, and ``glabc.mesh.all_sum`` spans, the reduced tensor) over the
window's jobs, over the number of ``glabc.epoch`` spans, in MB (1e6
bytes); None on one chip or without them."""

from perfbench.harness.spans import per, records


def read(rc):
    if rc.world < 2:
        return None
    v = per(records(), "glabc.mesh.", "nbytes", "glabc.epoch")
    return None if v is None else v * 1e-6
