"""The port's models/perceptual.py against the JAX package's on the CPU,
on the same numpy parameters and images, made from seeds (random
weights: the repository holds no checkpoint).

Tolerances: LPIPS(alex) rel 1e-5 (both sum f32 conv products over the
channels in their own order), at the JAX test's reduced widths and at
AlexNet's real ones; the ViT's patch tokens rtol 1e-5 with an atol of 1e-5
of the largest (twelve f32 layers, matmuls summed in another order);
the bicubic resize weights atol 1e-6 (the port builds them in float64,
jax.image in float32); the loaders' dicts equal; ViTPatchExtractor's
selection of patches equal, its descriptors rtol 1e-5; the eval's
`lpips` rel 1e-5 per pose and in the means.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fisher_nerf_customized_tpu.engine import eval as jeval
from fisher_nerf_customized_tpu.envs.fake_sim import BoxScene as JScene
from fisher_nerf_customized_tpu.models import perceptual as jp
from fisher_nerf_customized_tpu_torch.engine import eval as teval
from fisher_nerf_customized_tpu_torch.envs.fake_sim import BoxScene as TScene
from fisher_nerf_customized_tpu_torch.models import perceptual as tp

from test_perceptual import _tiny_alex_params, _tiny_vit_params

ALEX_REAL = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
             (256, 256, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def real_alex_params(rng):
    """Random weights at AlexNet's widths (He-scaled, so the activations
    stay O(1) through the five layers)."""
    p = {}
    for (cin, cout, k), i in zip(ALEX_REAL, (0, 3, 6, 8, 10)):
        p[f"features.{i}.weight"] = (rng.normal(size=(cout, cin, k, k))
                                     * np.sqrt(2.0 / (cin * k * k))
                                     ).astype(np.float32)
        p[f"features.{i}.bias"] = (rng.normal(size=(cout,)) * 0.1
                                   ).astype(np.float32)
    for li, (_, cout, _) in enumerate(ALEX_REAL):
        p[f"lin{li}.model.1.weight"] = (np.abs(rng.normal(
            size=(1, cout, 1, 1))) * 0.1).astype(np.float32)
    return p


def image_pairs(rng, p, size):
    a = rng.uniform(size=(p, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    return a, b


@pytest.mark.parametrize("widths", ["reduced", "alexnet"])
def test_lpips_alex_matches_jax(widths):
    rng = np.random.default_rng(0)
    p = _tiny_alex_params(rng) if widths == "reduced" else \
        real_alex_params(rng)
    a, b = image_pairs(rng, 3, 64)
    net = tp.LPIPSAlex.from_flat(p)
    assert set(net.state_dict()) == set(p)
    got = net(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (3,)
    ref = np.array([float(jp.lpips_alex(p, x, y)) for x, y in zip(a, b)])
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    same = net(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-6)
    flat = net.to_flat()
    assert all(np.array_equal(flat[k], p[k]) for k in p)


def test_lpips_alexnet_layout():
    """The default module has torchvision's alexnet.features names and
    widths, and lpips' lin names."""
    net = tp.LPIPSAlex()
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    for (cin, cout, k), i in zip(ALEX_REAL, (0, 3, 6, 8, 10)):
        assert shapes[f"features.{i}.weight"] == (cout, cin, k, k)
        assert shapes[f"features.{i}.bias"] == (cout,)
    for li, (_, cout, _) in enumerate(ALEX_REAL):
        assert shapes[f"lin{li}.model.1.weight"] == (1, cout, 1, 1)
    assert len(shapes) == 15


def lpips_state_dict(p):
    """p in the full lpips.LPIPS naming (net.sliceK.<features idx>.*)."""
    slice_of = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}
    sd = {}
    for k, v in p.items():
        if k.startswith("features."):
            i = int(k.split(".")[1])
            sd[f"net.slice{slice_of[i]}.{i}.{k.split('.')[2]}"] = \
                torch.tensor(v)
        else:
            sd[k] = torch.tensor(v)
    sd["scaling_layer.shift"] = torch.tensor(jp._SHIFT)[None, :, None, None]
    sd["scaling_layer.scale"] = torch.tensor(jp._SCALE)[None, :, None, None]
    return sd


def test_lpips_loaders_match(tmp_path):
    p = _tiny_alex_params(np.random.default_rng(1))
    full = tmp_path / "lpips.pth"
    torch.save(lpips_state_dict(p), full)
    got, ref = tp.load_torch_lpips(str(full)), jp.load_torch_lpips(str(full))
    assert set(got) == set(ref) == set(p)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    # the distributed lin-only file plus torchvision's alexnet checkpoint
    lin, alex = tmp_path / "alex.pth", tmp_path / "alexnet.pth"
    torch.save({k: torch.tensor(v) for k, v in p.items()
                if k.startswith("lin")}, lin)
    torch.save({k: torch.tensor(v) for k, v in p.items()
                if k.startswith("features")}
               | {"classifier.1.weight": torch.zeros(2, 2)}, alex)
    got = tp.load_torch_lpips(str(lin), str(alex))
    ref = jp.load_torch_lpips(str(lin), str(alex))
    assert set(got) == set(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    for fn in (tp.load_torch_lpips, jp.load_torch_lpips):
        with pytest.raises(ValueError, match="missing keys"):
            fn(str(lin))


def jax_resize_weights(n_in, n_out):
    """jax.image.resize's weights along one axis, read off the resize of
    the identity."""
    eye = jnp.eye(n_in, dtype=jnp.float32)[:, :, None]
    return np.asarray(jax.image.resize(eye, (n_in, n_out, 1), "bicubic"))[
        :, :, 0]


@pytest.mark.parametrize("n_in,n_out", [(4, 6), (37, 18), (37, 37),
                                        (6, 3), (5, 11), (16, 7)])
def test_resize_weights_match_jax(n_in, n_out):
    np.testing.assert_allclose(tp._resize_matrix(n_in, n_out),
                               jax_resize_weights(n_in, n_out), atol=1e-6)


def assert_tokens_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("layerscale,registers", [(True, 0), (False, 0),
                                                  (True, 4)])
@pytest.mark.parametrize("size", [16, 24, 8, 20])
def test_vit_matches_jax(layerscale, registers, size):
    """Grid 4x4 at 16², upscaled to 6x6 at 24², downscaled to 2x2 at 8²,
    and 5x5 at 20² (the position grid resized, the registers between
    cls and the patches)."""
    rng = np.random.default_rng(2)
    p = _tiny_vit_params(rng, layerscale=layerscale)
    if registers:
        p["register_tokens"] = rng.normal(
            size=(1, registers, 32)).astype(np.float32)
    imgs = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    net = tp.DinoViT.from_flat(p, num_heads=2)
    assert set(net.state_dict()) == set(p)
    got = net(torch.from_numpy(imgs)).numpy()
    for g, img in zip(got, imgs):
        ref = np.asarray(jp.vit_patch_descriptors(p, img, 2))
        assert g.shape == ref.shape == ((size // 4) ** 2, 32)
        assert_tokens_close(g, ref)


def test_vit_s14_layout():
    """The default module: ViT-S/14 at DINOv2's widths, loadable by
    DINOv2's names."""
    net = tp.DinoViT()
    sd = net.state_dict()
    assert sd["patch_embed.proj.weight"].shape == (384, 3, 14, 14)
    assert sd["pos_embed"].shape == (1, 1 + 37 * 37, 384)
    assert sd["blocks.11.mlp.fc1.weight"].shape == (1536, 384)
    assert "blocks.11.ls2.gamma" in sd and "blocks.12.norm1.weight" not in sd
    assert net.num_heads == 6
    tp.DinoViT.from_flat(net.to_flat(), 6)


def test_vit_loaders_match(tmp_path):
    rng = np.random.default_rng(4)
    p = _tiny_vit_params(rng)
    for i, wrap in enumerate((lambda sd: sd, lambda sd: {"model": sd})):
        path = tmp_path / f"vit{i}.pth"
        torch.save(wrap({k: torch.tensor(v) for k, v in p.items()}), path)
        got, heads = tp.load_torch_vit(str(path))
        ref, ref_heads = jp.load_torch_vit(str(path))
        assert heads == ref_heads == 1
        assert set(got) == set(ref) == set(p)
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    bad = tmp_path / "bad.pth"
    torch.save({"cls_token": torch.zeros(1, 1, 4)}, bad)
    for fn in (tp.load_torch_vit, jp.load_torch_vit):
        with pytest.raises(ValueError, match="missing key"):
            fn(str(bad))


@pytest.mark.parametrize("frac", [0.3, 0.5])
def test_vit_extractor_matches_jax(frac, tmp_path):
    rng = np.random.default_rng(5)
    p = _tiny_vit_params(rng)
    path = tmp_path / "vit.pth"
    torch.save({k: torch.tensor(v) for k, v in p.items()}, path)
    got_x = tp.ViTPatchExtractor.from_checkpoint(str(path), device="cpu",
                                                 min_mask_frac=frac)
    ref_x = jp.ViTPatchExtractor(p, 1, min_mask_frac=frac)
    img = rng.uniform(size=(18, 17, 3)).astype(np.float32)   # 4x4 patches
    mask = np.zeros((18, 17), bool)
    mask[1:9, 2:11] = True
    got, ref = got_x(img, mask), ref_x(img, mask)
    assert got.shape == ref.shape and len(ref) > 0
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # a tensor already on the extractor's device (the driver's frame on
    # the card) gives the numpy input's descriptors exactly
    np.testing.assert_array_equal(got_x(torch.from_numpy(img), mask), got)
    for m, im in ((np.zeros((18, 17), bool), img),
                  (np.ones((3, 3), bool), img[:3, :3])):
        assert got_x(im, m).shape == ref_x(im, m).shape == (0, 1)


# -- the eval's LPIPS ------------------------------------------------------------

@pytest.fixture
def lpips_weights(tmp_path):
    p = _tiny_alex_params(np.random.default_rng(6))
    path = tmp_path / "lp.pth"
    torch.save({k: torch.tensor(v) for k, v in p.items()}, path)
    yield str(path)
    jeval.set_lpips_weights(None)
    teval.set_lpips_weights(None)


def test_render_metrics_lpips_matches_jax(lpips_weights):
    rng = np.random.default_rng(7)
    a, b = image_pairs(rng, 2, 32)
    jeval.set_lpips_weights(lpips_weights)
    teval.set_lpips_weights(lpips_weights)
    for x, y in zip(a, b):
        ref = jeval.render_metrics(x, y)
        got = teval.render_metrics(torch.from_numpy(x), y)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    teval.set_lpips_weights(None)
    assert "lpips" not in teval.render_metrics(torch.from_numpy(a[0]), b[0])


def test_eval_navigation_lpips_matches_jax(lpips_weights):
    """Both packages' eval_navigation over 6 poses of stub maps and sims
    that hand them the same seeded images (32 x 40), the LPIPS weights
    set: the JAX package scores pose by pose, the port in batches of 4;
    each pose's metrics and the means agree."""
    def image(c2w, salt):
        rng = np.random.default_rng(int(abs(c2w[0, 3]) * 1e4) + salt)
        depth = rng.uniform(0.1, 4.0, (32, 40)).astype(np.float32)
        depth[:3] = 0.0
        return rng.uniform(0, 1, (32, 40, 3)).astype(np.float32), depth

    class Sim:
        def render_at(self, c2w):
            return image(c2w, 0)

    class JMap:
        def render_at_pose(self, c2w):
            rgb, depth = image(c2w, 1)
            return dict(render=jnp.asarray(rgb), depth=jnp.asarray(depth))

    class TMap:
        def render_at_poses(self, c2ws):
            ims = [image(c, 1) for c in c2ws]
            return dict(render=torch.from_numpy(np.stack([i[0] for i in ims])),
                        depth=torch.from_numpy(np.stack([i[1] for i in ims])))

    jeval.set_lpips_weights(lpips_weights)
    teval.set_lpips_weights(lpips_weights)
    ref = jeval.eval_navigation(JMap(), Sim(), JScene.multi_room(seed=1),
                                n_poses=6)
    got = teval.eval_navigation(TMap(), Sim(), TScene.multi_room(seed=1),
                                n_poses=6, chunk=4)
    assert list(got) == list(ref)
    assert "lpips" in got and got["n_poses"] == 6
    for g, r in zip(got["per_pose"], ref["per_pose"]):
        assert list(g) == list(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
    for k in ("psnr", "ssim", "lpips_proxy", "lpips", "depth_mae"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def test_eval_nvs_lpips_matches_jax(lpips_weights):
    """Both packages' eval_nvs over 4 recorded frames (32 x 40) of a stub
    map, the LPIPS weights set: `lpips` in each frame's row and in the
    means, on the valid-depth pixels."""
    rng = np.random.default_rng(8)
    frames = []
    for i in range(4):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = i * 0.3
        depth = rng.uniform(0.1, 4.0, (32, 40)).astype(np.float32)
        depth[:4] = 0.0
        frames.append((rng.uniform(0, 1, (32, 40, 3)).astype(np.float32),
                       depth, c2w))
    renders = {float(c[0, 3]): (rng.uniform(0, 1, (32, 40, 3)).astype(
        np.float32), rng.uniform(0.1, 4.0, (32, 40)).astype(np.float32))
        for _r, _d, c in frames}

    class Map:
        def __init__(self, to):
            self.to = to

        def render_at_pose(self, c2w):
            rgb, depth = renders[float(c2w[0, 3])]
            return dict(render=self.to(rgb), depth=self.to(depth),
                        sil=self.to(np.ones_like(depth)))

    jeval.set_lpips_weights(lpips_weights)
    teval.set_lpips_weights(lpips_weights)
    ref = jeval.eval_nvs(Map(jnp.asarray), frames)
    got = teval.eval_nvs(Map(torch.from_numpy), frames)
    assert list(got) == list(ref) and "lpips" in got
    for g, r in zip(got["per_frame"], ref["per_frame"]):
        assert list(g) == list(r)
        np.testing.assert_allclose(g["lpips"], r["lpips"], rtol=1e-5)
    np.testing.assert_allclose(got["lpips"], ref["lpips"], rtol=1e-5)
