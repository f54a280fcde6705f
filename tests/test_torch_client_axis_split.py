"""The chunked rounds of mtsl, parallelsfl, smofi and splitfed against
their dense rounds and the reference's chunked rounds (the checks of
tests/test_torch_client_axis.py, shared through
tests/torch_client_axis.py; the file is split so each stays short)."""
import pytest

from torch_client_axis import check_chunked_round


@pytest.mark.parametrize("alg", ["mtsl", "parallelsfl", "smofi", "splitfed"])
@pytest.mark.parametrize("sched_name", ["full", "masked"])
def test_chunked_round_matches_dense_and_reference(alg, sched_name):
    check_chunked_round(alg, sched_name)
