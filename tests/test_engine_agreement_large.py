"""Brute-vs-BVH agreement on the larger shipped scenes (see
test_engine_agreement.py)."""

import pytest

from tests.test_engine_agreement import NEE_MODES, check_agreement


@pytest.mark.parametrize("nee", NEE_MODES, ids=lambda n: n.name.lower())
@pytest.mark.parametrize("name", ["FurnaceTest.glb", "PBRTest.glb", "BreakTime.glb"])
def test_brute_and_bvh_agree(name, nee):
    check_agreement(name, nee)
