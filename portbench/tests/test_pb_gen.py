"""The traffic generator: deterministic per seed, and every seed makes the
same set of cloud sizes."""
import torch

from portbench import gen

KW = dict(n_frames=5, n_max=4096, point_range=(2000, 3000), n_objects=12,
          speed_range_mps=(0, 15), ego_speed_mps=8.0, ground_points=300,
          scene_seed=3)


def test_same_seed_same_drive():
    a = gen.make_drive(2**31 + 77, **KW)
    b = gen.make_drive(2**31 + 77, **KW)
    assert torch.equal(a.points, b.points) and torch.equal(a.valid, b.valid)
    assert torch.equal(a.obj_centers, b.obj_centers)


def test_seeds_share_the_sizes():
    a = gen.make_drive(1, **KW)
    b = gen.make_drive(2, **KW)
    assert not torch.equal(a.points, b.points)
    assert sorted(a.counts.tolist()) == sorted(b.counts.tolist())
    assert a.valid.sum(1).tolist() == a.counts.tolist()
    assert (a.ground.sum(1) == 300).all()
    for x, y in ((a.obj_dims, b.obj_dims), (a.obj_speed, b.obj_speed),
                 (a.obj_points, b.obj_points)):
        assert torch.equal(x.sort(0).values, y.sort(0).values)
    assert sorted(gen.objects_per_drive(8, 24, 8, 1)) == \
        sorted(gen.objects_per_drive(8, 24, 8, 2)) == [8, 10, 13, 15, 17, 19, 22, 24]


def test_valid_points_inside_the_crop_and_under_the_ceiling():
    d = gen.make_drive(3, **KW)
    pts = d.points[d.valid]
    assert (pts[:, :2].abs() < 50).all()
    assert (pts[:, 2] < 1.0).all() and (pts[:, 2] > -2.0).all()
