"""Multi-host (DCN) backend with multiple local devices per fake
host: the per-host mesh-batch shard path (segment_tile_batch) driven
through real subprocesses.

Split from test_dcn.py so the process-sharded runner (scripts/partest.py)
can schedule the suite's heaviest modules on separate workers.
"""

import pytest

from test_dcn import test_dcn_matches_serial as _dcn_case


@pytest.mark.parametrize("nproc,localdev,tpd", [(2, 2, 1), (2, 2, 2)])
def test_dcn_mesh_matches_serial(tmp_path, rng, nproc, localdev, tpd):
    # the parametrize mark on the imported test doesn't wrap the function,
    # so it is directly callable with explicit arguments
    _dcn_case(tmp_path, rng, nproc, localdev, tpd)
