"""The port's mesh helpers (`repro_torch.launch.mesh`,
`repro_torch.utils.sharding`) against the reference's
(`repro.launch.mesh`, `repro.utils.sharding`), without a process group:

  * `parse_mesh_spec` on valid and invalid strings: the same dicts, and
    the same refusals with the same messages;
  * `num_clients_for` and `client_axis_size` on meshes of every axis
    combination;
  * `logical_to_spec` on a grid of shapes, logical names and mesh sizes.
    The reference reads only `mesh.shape` (a name -> size mapping), so
    both take the same stub; a reference PartitionSpec is a tuple of the
    same entries as the port's spec.
"""
import itertools

import pytest

from repro.launch import mesh as ref_mesh
from repro.utils import sharding as ref_sharding
from repro_torch.launch import mesh
from repro_torch.utils import sharding


class StubMesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)


VALID = ["", "data=2", "data=4,model=2", "pod=2,data=2", "model=3",
         " data=8 , model=1 ", "pod=1,data=1,model=1", "model=2,data=2,pod=2"]
INVALID = ["data", "data=0", "data=-1", "data=x", "dat=2", "data=2,data=2",
           "data=2,", "=2", "data=2,gpu=4", "data=1.5"]


@pytest.mark.parametrize("spec", VALID)
def test_parse_mesh_spec_valid(spec):
    assert mesh.parse_mesh_spec(spec) == ref_mesh.parse_mesh_spec(spec)


@pytest.mark.parametrize("spec", INVALID)
def test_parse_mesh_spec_refusals(spec):
    with pytest.raises(ValueError) as want:
        ref_mesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
        mesh.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


SIZES = [{}, {"data": 4}, {"model": 2}, {"data": 2, "model": 2},
         {"pod": 2, "data": 2}, {"pod": 2, "data": 4, "model": 2}, {"pod": 3}]


@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: ",".join(
    f"{k}={v}" for k, v in s.items()) or "none")
def test_client_counts(sizes):
    stub = StubMesh(**sizes)
    assert mesh.num_clients_for(stub) == ref_mesh.num_clients_for(stub)
    assert sharding.client_axis_size(stub) == ref_sharding.client_axis_size(stub)
    assert sharding.client_mesh_axes(stub) == ref_sharding.client_mesh_axes(stub)
    assert mesh.mesh_size(sizes) == max(1, sharding._axis_size(sizes, tuple(sizes)))


LOGICAL = [("client", "embed"), ("client", "heads", "head_dim"),
           ("batch", "kv_seq", "kv_heads"), ("layers", "ffn", "embed"),
           ("experts", "embed", "expert_ffn"), ("vocab", None),
           ("kv_seq",), ("fsdp", "ffn"), ("client", "batch"), ("unknown", "ssm_heads")]
SHAPES = [(8, 6), (6, 4), (12, 8), (3, 7), (16, 32, 5)]
MESHES = [{"data": 2}, {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 2},
          {"model": 3}, {"pod": 2, "data": 3}]


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: ",".join(
    f"{k}={v}" for k, v in s.items()))
def test_logical_to_spec_matches_reference(sizes):
    stub = StubMesh(**sizes)
    n = 0
    for logical, shape in itertools.product(LOGICAL, SHAPES):
        shape = shape[:len(logical)] + (4,) * (len(logical) - len(shape))
        want = tuple(ref_sharding.logical_to_spec(stub, logical, shape))
        assert sharding.logical_to_spec(stub, logical, shape) == want, (logical, shape)
        # the same with an override rule, as a caller may pass
        rules = {"embed": ("data",)}
        want = tuple(ref_sharding.logical_to_spec(stub, logical, shape, rules))
        assert sharding.logical_to_spec(stub, logical, shape, rules) == want
        n += 1
    assert n == len(LOGICAL) * len(SHAPES)
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES


def test_not_a_mesh():
    with pytest.raises(TypeError, match="not a mesh"):
        sharding.client_axis_size(object())
    # the mapping form reads as the stub does
    assert sharding.mesh_axis_sizes({"data": 2}) == {"data": 2}
    with pytest.raises(ValueError, match="not divisible"):
        sharding.ClientGroup(None, 4, 1).rows(6)
    assert sharding.ClientGroup(None, 4, 1).rows(8) == slice(2, 4)
