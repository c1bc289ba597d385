"""The plain reference: the field, the code, and agreement with the port's
CPU plain version at a tiny width (this test may import both; the
reference itself imports nothing of the port)."""

import numpy as np
import pytest
import torch

from ecbench import reference, workload

GEOMETRIES = [(10, 4), (12, 4)]


def test_field_inverse_and_doubling():
    for a in range(1, 256):
        assert reference.gf_mul(a, reference.gf_inv(a)) == 1
    x = torch.arange(256, dtype=torch.uint8)
    want = torch.tensor([reference.gf_mul(2, int(v)) for v in range(256)], dtype=torch.uint8)
    assert torch.equal(reference.xtime(x), want)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_generator_is_systematic(k, m):
    gen = reference.generator(k, m)
    assert gen.shape == (k + m, k)
    assert np.array_equal(gen[:k], np.eye(k, dtype=np.uint8))


@pytest.mark.parametrize("k,m", GEOMETRIES)
@pytest.mark.parametrize("lost", [(0,), (0, 5), (0, 5, 11, 13), (1, 2, 3, 4)])
def test_rebuild_of_encode_gives_back_the_lost_shards(k, m, lost):
    g = torch.Generator().manual_seed(k * 100 + len(lost))
    data = torch.randint(0, 256, (3, k, 257), dtype=torch.uint8, generator=g)
    word = torch.cat([data, reference.apply(reference.parity_matrix(k, m), data)], dim=-2)
    survivors = reference.survivors_of(k, m, lost)
    rm = reference.rebuild_matrix(k, m, survivors, lost)
    got = reference.apply(rm, word[:, survivors, :].contiguous())
    assert torch.equal(got, word[:, list(lost), :])


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reference_agrees_with_the_port_on_the_cpu(k, m):
    from seaweedfs_tpu_torch.ops import rs_codec

    enc = rs_codec.new_encoder(k, m, "vandermonde", device="cpu")
    g = torch.Generator().manual_seed(k)
    data = torch.randint(0, 256, (2, k, 1003), dtype=torch.uint8, generator=g)
    parity = reference.apply(reference.parity_matrix(k, m), data)
    assert np.array_equal(np.asarray(enc.encode_parity_lazy(data.numpy())), parity.numpy())
    lost = [0, 5, k + 1, k + 3]
    survivors = reference.survivors_of(k, m, lost)
    word = torch.cat([data, parity], dim=-2)
    stack = word[:, survivors, :].contiguous()
    got = np.asarray(enc.reconstruct_lazy(stack.numpy(), survivors, lost))
    assert np.array_equal(got, word[:, lost, :].numpy())


def test_inputs_repeat_from_the_seed_and_differ_by_slot():
    p = workload.plan(workload.config_file("rs12p4-minio"), workload.traffic_file("encode"),
                      max_width=300)
    cpu = torch.device("cpu")
    a = workload.make_inputs(p, 2**31 + 5, cpu)
    b = workload.make_inputs(p, 2**31 + 5, cpu)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    assert not np.any(a[0][-1, -p.pad:])  # the split's zero padding


def test_call_shapes_are_the_deployments():
    enc = workload.plan(workload.config_file("rs10p4-30g"), workload.traffic_file("encode"))
    assert enc.shape == (10, 25 * 256 * 1024) and enc.out_shape == (4, 6553600)
    rb4 = workload.plan(workload.config_file("rs10p4-30g"), workload.traffic_file("rebuild4"))
    assert rb4.shape == (10, 4 << 20) and rb4.survivors == (1, 2, 3, 4, 6, 7, 8, 9, 10, 12)
    rb1 = workload.plan(workload.config_file("rs10p4-30g"), workload.traffic_file("rebuild1"))
    assert rb1.out_shape == (1, 4 << 20)
    minio = workload.plan(workload.config_file("rs12p4-minio"), workload.traffic_file("encode"))
    assert minio.shape == (12, 87382) and minio.pad == 8 and minio.width % 16 == 6
    assert minio.in_bytes == 12 * 87382 and minio.out_shape == (4, 87382)
