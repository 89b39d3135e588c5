"""Activation / gradient parity against torch oracles.

PyG and pytorch3d are not installed in this environment, so the oracles are
minimal torch implementations following the exact documented semantics of
the reference's building blocks:
- GATv2Conv (PyG defaults: share_weights=False, add_self_loops=False,
  concat=True, Glorot linears, zero biases) as used in reference
  layers.py:304-309.
- torch Linear / LayerNorm stacks (reference get_linear_layers).
- The ESFM loss including its gradient-equalization backward hook
  (reference loss_functions.py:69-123) — compared both on values and on
  gradients w.r.t. cameras and points.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from gasfm.config import ConfigFactory
from gasfm.data.synthetic import generate_synthetic_scene
from gasfm.losses import ESFMLoss
from gasfm.models.layers import GATv2SegmentConv, MLPStack

torch.set_default_dtype(torch.float64)


# ---------------------------------------------------------------------------
# GATv2 oracle
# ---------------------------------------------------------------------------


def torch_gatv2_star(x_src, query, W_l, b_l, W_r, b_r, att, bias, seg_ids, num_segments):
    """PyG GATv2Conv on a star graph: every source row attends into its
    segment's aggregation node whose input features are `query`."""
    E = x_src.shape[0]
    H, C = att.shape
    xl = x_src @ W_l.T + b_l  # (E, H*C)
    xr = query @ W_r.T + b_r  # (S, H*C)
    g = (xl + xr[seg_ids]).view(E, H, C)
    g = F.leaky_relu(g, negative_slope=0.2)
    logits = (g * att[None]).sum(-1)  # (E, H)
    # segment softmax
    out = torch.zeros(num_segments, H, C, dtype=x_src.dtype)
    for s in range(num_segments):
        idx = (seg_ids == s).nonzero(as_tuple=True)[0]
        if len(idx) == 0:
            continue
        alpha = torch.softmax(logits[idx], dim=0)  # (k, H)
        out[s] = (alpha[:, :, None] * xl[idx].view(-1, H, C)).sum(0)
    return out.reshape(num_segments, H * C) + bias


class TestGATv2Parity:
    @pytest.mark.parametrize("stateful", [False, True])
    def test_matches_torch_oracle(self, stateful):
        rng = np.random.default_rng(0)
        E, S, d_in, H, C = 200, 9, 12, 4, 8
        x_src = rng.normal(size=(E, d_in))
        seg_ids = rng.integers(0, S, size=E)
        # ensure every segment non-empty
        seg_ids[:S] = np.arange(S)
        query = rng.normal(size=(S, d_in)) if stateful else np.zeros((S, d_in))

        conv = GATv2SegmentConv(in_feat=d_in, out_per_head=C, heads=H)
        params = conv.init(
            jax.random.PRNGKey(0), jnp.asarray(x_src, jnp.float32),
            jnp.asarray(seg_ids, jnp.int32), S,
            query=jnp.asarray(query, jnp.float32) if stateful else None,
            edge_mask=jnp.ones(E, bool),
        )
        p = params["params"]
        out_jax = conv.apply(
            params, jnp.asarray(x_src, jnp.float32), jnp.asarray(seg_ids, jnp.int32), S,
            query=jnp.asarray(query, jnp.float32) if stateful else None,
            edge_mask=jnp.ones(E, bool),
        )

        out_torch = torch_gatv2_star(
            torch.tensor(x_src),
            torch.tensor(query),
            torch.tensor(np.asarray(p["lin_l_kernel"]).T.astype(np.float64)),
            torch.tensor(np.asarray(p["lin_l_bias"]).astype(np.float64)),
            torch.tensor(np.asarray(p["lin_r_kernel"]).T.astype(np.float64)),
            torch.tensor(np.asarray(p["lin_r_bias"]).astype(np.float64)),
            torch.tensor(np.asarray(p["att"]).astype(np.float64)),
            torch.tensor(np.asarray(p["bias"]).astype(np.float64)),
            torch.tensor(seg_ids),
            S,
        )
        np.testing.assert_allclose(
            np.asarray(out_jax), out_torch.numpy(), atol=1e-5, rtol=1e-5
        )

    @pytest.mark.parametrize("stateful", [False, True])
    def test_single_segment_pool_matches_torch_oracle(self, stateful):
        """The dense num_segments==1 pool path (view/point -> global star
        graphs, reference layers.py:538-603) must agree with the same torch
        oracle; invalid rows are routed to a trash segment id 1 + mask, as
        ViewAndScenePoint2Global does."""
        rng = np.random.default_rng(1)
        E, d_in, H, C = 73, 12, 4, 8
        x_src = rng.normal(size=(E, d_in))
        valid = rng.random(E) < 0.8
        valid[:2] = True
        seg_ids = np.where(valid, 0, 1)
        query = rng.normal(size=(1, d_in)) if stateful else np.zeros((1, d_in))

        conv = GATv2SegmentConv(in_feat=d_in, out_per_head=C, heads=H)
        args = (jnp.asarray(x_src, jnp.float32), jnp.asarray(seg_ids, jnp.int32), 1)
        kw = dict(
            query=jnp.asarray(query, jnp.float32) if stateful else None,
            edge_mask=jnp.asarray(valid),
        )
        params = conv.init(jax.random.PRNGKey(0), *args, **kw)
        p = params["params"]
        out_jax = conv.apply(params, *args, **kw)

        out_torch = torch_gatv2_star(
            torch.tensor(x_src[valid]),
            torch.tensor(query),
            torch.tensor(np.asarray(p["lin_l_kernel"]).T.astype(np.float64)),
            torch.tensor(np.asarray(p["lin_l_bias"]).astype(np.float64)),
            torch.tensor(np.asarray(p["lin_r_kernel"]).T.astype(np.float64)),
            torch.tensor(np.asarray(p["lin_r_bias"]).astype(np.float64)),
            torch.tensor(np.asarray(p["att"]).astype(np.float64)),
            torch.tensor(np.asarray(p["bias"]).astype(np.float64)),
            torch.tensor(np.zeros(int(valid.sum()), dtype=np.int64)),
            1,
        )
        np.testing.assert_allclose(
            np.asarray(out_jax), out_torch.numpy(), atol=1e-5, rtol=1e-5
        )


# ---------------------------------------------------------------------------
# Linear/LayerNorm stack oracle
# ---------------------------------------------------------------------------


class TestMLPStackParity:
    @pytest.mark.parametrize(
        "feats,init_act,final_act,norm",
        [
            ((16, 16), False, False, False),
            ((16, 32, 8), False, False, True),
            ((16, 16, 16), True, True, True),
        ],
    )
    def test_matches_torch(self, feats, init_act, final_act, norm):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(50, feats[0]))
        mlp = MLPStack(feats, init_activation=init_act, final_activation=final_act, norm=norm)
        params = mlp.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))
        out_jax = np.asarray(mlp.apply(params, jnp.asarray(x, jnp.float32)))

        # torch oracle mirroring reference get_linear_layers (layers.py:10-44)
        flat = params["params"]
        t = torch.tensor(x)

        def apply_ln(t, ln_params):
            w = torch.tensor(np.asarray(ln_params["scale"]).astype(np.float64))
            b = torch.tensor(np.asarray(ln_params["bias"]).astype(np.float64))
            return F.layer_norm(t, (t.shape[-1],), w, b, eps=1e-5)

        # Reconstruct op order from the module structure
        ln_names = sorted([k for k in flat if k.startswith("LayerNorm")],
                          key=lambda s: int(s.split("_")[1]) if "_" in s else 0)
        dense_names = sorted([k for k in flat if k.startswith("TorchDense")],
                             key=lambda s: int(s.split("_")[1]) if "_" in s else 0)
        ln_i = 0
        if init_act:
            if norm:
                t = apply_ln(t, flat[ln_names[ln_i]]); ln_i += 1
            t = F.relu(t)
        for i, dn in enumerate(dense_names):
            W = torch.tensor(np.asarray(flat[dn]["kernel"]).astype(np.float64))
            b = torch.tensor(np.asarray(flat[dn]["bias"]).astype(np.float64))
            t = t @ W + b
            is_last = i == len(dense_names) - 1
            if not is_last:
                if norm:
                    t = apply_ln(t, flat[ln_names[ln_i]]); ln_i += 1
                t = F.relu(t)
        if final_act:
            if norm:
                t = apply_ln(t, flat[ln_names[ln_i]]); ln_i += 1
            t = F.relu(t)
        np.testing.assert_allclose(out_jax, t.numpy(), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# ESFM loss + gradient-equalization hook oracle
# ---------------------------------------------------------------------------


def torch_esfm_loss_and_grads(Ps, X4, norm_M, valid_pts, margin, hinge_w, equalize, valid_only):
    """The reference ESFMLoss (loss_functions.py:85-123) verbatim in torch,
    minus the CUDA assert. Returns (loss, dPs, dX)."""
    Ps = torch.tensor(Ps, requires_grad=True)
    X4 = torch.tensor(X4, requires_grad=True)
    valid = torch.tensor(valid_pts)

    pts_2d = Ps @ X4  # (m, 3, n)
    pos_mask = pts_2d[:, 2, :] >= margin

    if equalize:
        if valid_only:
            count = max(1, int((valid & pos_mask).sum()))
            pts_2d.register_hook(
                lambda grad: torch.where(
                    pos_mask[:, None, :].repeat(1, 3, 1),
                    F.normalize(grad, dim=1) / count,
                    grad,
                )
            )
        else:
            total = valid.sum()
            pts_2d.register_hook(lambda grad: F.normalize(grad, dim=1) / total)

    hinge = (margin - pts_2d[:, 2, :]) * hinge_w
    denom = torch.where(pos_mask, pts_2d[:, 2, :], torch.ones_like(pts_2d[:, 2, :]))
    proj = pts_2d / denom[:, None, :]
    reproj = (proj[:, 0:2, :] - torch.tensor(norm_M)).norm(dim=1)
    loss = torch.where(pos_mask, reproj, hinge)[valid].mean()
    loss.backward()
    return float(loss), Ps.grad.numpy(), X4.grad.numpy()


class TestESFMLossParity:
    @pytest.mark.parametrize("equalize,valid_only", [(False, False), (True, True), (True, False)])
    def test_loss_and_grads_match_reference_formula(self, equalize, valid_only):
        conf = ConfigFactory.parse_string(f"""
model {{ view_head {{ enabled = true }}, scenepoint_head {{ enabled = true }}, depth_head {{ enabled = false }} }}
loss {{
  func = "ESFMLoss"
  infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = {str(equalize).lower()}
  normalize_grad_wrt_valid_projections_only = {str(valid_only).lower()}
  hinge_loss = true
  hinge_loss_weight = 1
}}
""")
        loss_fn = ESFMLoss(conf)
        data = generate_synthetic_scene(n_views=6, n_points=40, seed=3, noise_px=1.0)
        scene = data.to_scene_graph()
        m, n = data.num_views, data.num_points

        rng = np.random.default_rng(0)
        # Mildly perturbed GT cameras (mixed positive/negative depths).
        Ps_norm = np.einsum("mij,mjk->mik", data.Ns.astype(np.float64), data.y.astype(np.float64))
        Ps_norm = Ps_norm + 0.05 * rng.normal(size=Ps_norm.shape)
        X4 = np.concatenate([rng.normal(size=(3, n)), np.ones((1, n))], axis=0)

        # JAX loss + grads on padded arrays
        m_cap, n_cap = scene.graph.num_cams, scene.graph.num_pts
        Ps_pad = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1), (m_cap, 1, 1))
        Ps_pad[:m] = Ps_norm
        X_pad = np.zeros((4, n_cap))
        X_pad[3] = 1
        X_pad[:, :n] = X4

        def f(Ps, X):
            return loss_fn({"Ps_norm": Ps, "pts3D": X}, scene)

        loss_jax, (gP, gX) = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(Ps_pad, jnp.float32), jnp.asarray(X_pad, jnp.float32)
        )

        # Torch oracle on unpadded dense arrays
        norm_M_t = data.norm_M.astype(np.float64).transpose(0, 2, 1)  # (m, 2, n)
        loss_t, gP_t, gX_t = torch_esfm_loss_and_grads(
            Ps_norm, X4, norm_M_t, data.valid_pts, 1e-4, 1.0, equalize, valid_only
        )

        assert float(loss_jax) == pytest.approx(loss_t, rel=1e-4)
        np.testing.assert_allclose(np.asarray(gP)[:m], gP_t, atol=2e-5, rtol=1e-3)
        np.testing.assert_allclose(np.asarray(gX)[:, :n], gX_t, atol=2e-5, rtol=1e-3)
