"""Weights and training state carried across from the JAX package.

`from_jax_params` turns the JAX aggregator pytree (``{branch: [{"w": [in,
out], "b": [out]}, ...]}``, as numpy) and point arrays into the port's
`Aggregator` module and point-state tensors. `from_jax_train_state` carries
a whole JAX `TrainState` across, Adam moments and step included,
`from_jax_mvs_params` the MVS point init's nets (`MvsPoints`), and
`from_jax_gen_state` the generalizable driver's `GenTrainState`.
`load_net_ray_marching_npz` reads the ``{step}_net_ray_marching.npz`` every
JAX checkpoint writes (reference key names; torch Linear weights [out, in])
with numpy alone.

The driver's checkpoints (port of `pointnerf_tpu/utils/checkpoint.py:106-
214`) use the JAX package's files, so either side resumes the other's:

  {step}_net_ray_marching.npz  reference key names, active points only
  {step}_states.npz            counters (total_steps, best_PSNR, ...)
  {step}_full.npz              the whole train state under the JAX
                               `TrainState`'s key paths (`save_pytree_npz`),
                               both Adam states included
  {steps}_gen.npz              the generalizable driver's state under the
                               JAX `GenTrainState`'s key paths (the
                               aggregator, the FPN, premlp and
                               ProbNet, MVSNet, both Adam states,
                               the step)

The port writes the point-Adam moments per buffer
(``.opt_state_pts/0/.mu/{buffer}``) and reads that layout or the packed
one (``.opt_state_pts/0/.mu`` [cap, ΣC], sorted-key columns); JAX's
`load_pytree_npz` converts between them. Loading validates every width
against the options; the capacity follows the file. The jitter generator
is not part of the JAX state: a resumed run reseeds it from the seed and
the step.
"""

from __future__ import annotations

import glob
import os
import re
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.aggregator import (Aggregator, aggregator_from_layers,
                                 init_aggregator_params)
from ..models.mvs.nets import load_state
from ..models.mvs.points_model import MvsPoints
from ..models.neural_points import create_point_cloud
from ..train import trainer

_POINT_KEYS = {  # ours -> reference buffer name (neural_points.py:244-288)
    "xyz": "neural_points.xyz",
    "embedding": "neural_points.points_embeding",
    "conf": "neural_points.points_conf",
    "dir": "neural_points.points_dir",
    "color": "neural_points.points_color",
}
_LINEAR = re.compile(r"^aggregator\.(\w+)\.(\d+)\.(weight|bias)$")


def from_jax_params(agg_params: Dict, point_arrays: Dict,
                    act_type: str = "LeakyReLU", device="cuda"
                    ) -> Tuple[Aggregator, Dict[str, torch.Tensor]]:
    """JAX aggregator pytree + point arrays → (Aggregator, point state), on
    `device` (the card unless the caller names another).

    point_arrays is either a padded JAX point state (with "mask") or the
    unpadded host arrays of an exported checkpoint (xyz [N,3], embedding
    [N,C], color, dir, conf, Rw2c), which are padded by create_point_cloud.
    """
    layers = {name: [(np.asarray(l["w"], np.float32).T, l["b"]) for l in ls]
              for name, ls in agg_params.items()}
    agg = aggregator_from_layers(layers, act_type).to(device)
    pts = {k: (None if v is None else np.array(v))
           for k, v in point_arrays.items()}
    if "mask" in pts:
        state = {k: (None if v is None else torch.as_tensor(v, device=device))
                 for k, v in pts.items()}
    else:
        state = create_point_cloud(pts["xyz"], pts["embedding"],
                                   pts.get("color"), pts.get("dir"),
                                   pts.get("conf"), pts.get("Rw2c"),
                                   device=device)
    return agg, state


def _net_tensors(tree: Dict) -> Dict[str, np.ndarray]:
    """A JAX aggregator pytree (weights [in, out]) by the port's parameter
    names (``block1.0.weight`` [out, in])."""
    out = {}
    for branch, layers in tree.items():
        for i, layer in enumerate(layers):
            out[f"{branch}.{2 * i}.weight"] = np.asarray(layer["w"]).T
            out[f"{branch}.{2 * i}.bias"] = np.asarray(layer["b"])
    return out


def _adam_of(chain) -> object:
    """The scale_by_adam state (count, mu, nu) inside an optax chain's
    state, as numpy."""
    for s in chain:
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
    raise ValueError("no Adam state (mu, nu) in the optimizer state")


def _point_moments(m, template: Dict[str, torch.Tensor]) -> Dict:
    """Point moments in either JAX layout by buffer name: per buffer, or
    packed into one [cap, ΣC] array by sorted key (trainer.py:88-99). The
    packed columns are cut by the template's widths, which must add up to
    the packed width."""
    if isinstance(m, dict):
        return {k: np.asarray(m[k]) for k in template}
    m = np.asarray(m)
    widths = [(k, template[k].shape[1]) for k in sorted(template)]
    if m.ndim != 2 or m.shape[1] != sum(w for _, w in widths) \
            or m.shape[0] != next(iter(template.values())).shape[0]:
        raise ValueError(f"packed point moments of shape {m.shape} do not "
                         f"match the trainable buffers {widths}")
    out, off = {}, 0
    for k, w in widths:
        out[k] = m[:, off:off + w]
        off += w
    return out


def _load_adam(optim: torch.optim.Adam, params: Dict[str, torch.Tensor],
               adam, mu: Dict, nu: Dict) -> None:
    """JAX's Adam state (count, moments by name) into `optim`: the count
    on the parameters' device where the optimizer is capturable (the
    card's `trainer.Adam`), on the CPU otherwise; a `trainer.Adam` keeps
    it on the host too (`count`)."""
    n = int(np.asarray(adam.count))
    capturable = optim.defaults.get("capturable", False)
    for k, p in params.items():
        if tuple(mu[k].shape) != tuple(p.shape):
            raise ValueError(f"Adam moment of {k} has shape {mu[k].shape}, "
                             f"the parameter {tuple(p.shape)}")
        optim.state[p] = {
            "step": torch.tensor(float(n), dtype=torch.float32,
                                 device=p.device if capturable else "cpu"),
            "exp_avg": torch.as_tensor(np.array(mu[k], np.float32),
                                       device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(nu[k], np.float32),
                                          device=p.device)}
    if isinstance(optim, trainer.Adam):
        optim.count = n


def from_jax_train_state(ts, opt, device="cuda") -> "trainer.TrainState":
    """A JAX `TrainState` (leaves as numpy) → the port's TrainState: the
    aggregator, the point buffers, both optimizers' moments and counts,
    and the step. The point moments may come in either JAX layout (see
    `_point_moments`). The jitter generator is seeded 0 on `device`."""
    points = dict(ts.pt_static)
    points.update(ts.pt_train)
    agg, pts = from_jax_params(ts.agg_params, points, opt.act_type, device)
    state = trainer.make_train_state(
        agg, pts, opt, torch.Generator(device=device).manual_seed(0),
        int(np.asarray(ts.step)))
    if set(state.pt_train) != set(ts.pt_train):
        raise ValueError(f"trainable buffers {sorted(ts.pt_train)} in the "
                         f"JAX state, {sorted(state.pt_train)} by opt")
    adam = _adam_of(ts.opt_state_net)
    named = dict(agg.named_parameters())
    _load_adam(state.opt_net, named, adam, _net_tensors(adam.mu),
               _net_tensors(adam.nu))
    adam = _adam_of(ts.opt_state_pts)
    _load_adam(state.opt_pts, state.pt_train, adam,
               _point_moments(adam.mu, state.pt_train),
               _point_moments(adam.nu, state.pt_train))
    return state


_BN_KEYS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
# the U-Nets' transposed-conv blocks: {conv, bn} in the JAX trees, the
# original Sequential's {0, 1} in the port's
_UP_BLOCK = re.compile(r"^((?:mvsnet\.cost_regularization|probnet\.costreg)"
                       r"\.conv(?:7|9|11))\.(conv|bn)\.")


def _conv_keys(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """A JAX conv-net tree (dicts and lists; convs {w, b}, BatchNorm
    {scale, bias, mean, var}) → torch keys (OI[D]HW weights as they are)."""
    if isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            _conv_keys(t, f"{prefix}{i}.", out)
        return
    for k, v in tree.items():
        if k in ("w", "b"):
            out[prefix + ("weight" if k == "w" else "bias")] = np.asarray(v)
        elif k == "bn":
            for kk, vv in v.items():
                out[f"{prefix}bn.{_BN_KEYS[kk]}"] = np.asarray(vv)
        else:
            _conv_keys(v, f"{prefix}{k}.", out)


def _up_keys(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Conv keys of a JAX tree with the transposed-conv blocks renamed to
    the original `Sequential`'s (0: ConvTranspose3d, 1: BatchNorm3d)."""
    out = {}
    for k, v in flat.items():
        m = _UP_BLOCK.match(k)
        if m:
            k = f"{m.group(1)}.{0 if m.group(2) == 'conv' else 1}." \
                + k[m.end():]
        out[k] = v
    return out


def from_jax_mvs_params(params: Dict, opt, device="cuda") -> MvsPoints:
    """The JAX MVS parameter tree (`init_mvs_points_params`, leaves as
    numpy: mvsnet, featurenet, premlp, probnet) → the port's `MvsPoints`,
    on `device` (the card unless the caller names another). The transposed
    convs (CostRegNet's and ProbNet's conv7/9/11) take the original
    `Sequential`'s keys (0: ConvTranspose3d, 1: BatchNorm3d); premlp
    weights [in, out] become Linear's [out, in]."""
    mvs = MvsPoints(opt, torch.Generator(), device=device)
    flat: Dict[str, np.ndarray] = {}
    for name in ("mvsnet", "featurenet", "probnet"):
        if name in params:
            _conv_keys(params[name], f"{name}.", flat)
    sd = {k: torch.as_tensor(np.array(v, np.float32), device=device)
          for k, v in _up_keys(flat).items()}
    for i, layer in enumerate(params.get("premlp") or []):
        sd[f"premlp.{2 * i}.weight"] = torch.as_tensor(
            np.array(layer["w"], np.float32).T, device=device)
        sd[f"premlp.{2 * i}.bias"] = torch.as_tensor(
            np.array(layer["b"], np.float32), device=device)
    return load_state(mvs, sd)


def import_reference_dict(raw: Dict[str, np.ndarray], opt=None
                          ) -> Tuple[Dict, Dict]:
    """Reference-style key dict → (agg_params in the JAX layout, w [in,out];
    unpadded point arrays), ready for `from_jax_params`."""
    agg: Dict = {}
    for key, arr in raw.items():
        m = _LINEAR.match(key)
        if not m:
            continue
        branch, idx, kind = m.group(1), int(m.group(2)), m.group(3)
        layer = agg.setdefault(branch, {}).setdefault(idx // 2, {})
        if kind == "weight":
            layer["w"] = np.asarray(arr, np.float32).T
        else:
            layer["b"] = np.asarray(arr, np.float32)
    agg = {b: [ls[i] for i in sorted(ls)] for b, ls in agg.items()}
    pts = {}
    for ours, ref in _POINT_KEYS.items():
        if ref in raw:
            arr = np.asarray(raw[ref], np.float32)
            pts[ours] = arr[0] if arr.ndim == 3 else arr
    if "neural_points.Rw2c" in raw:
        pts["Rw2c"] = np.asarray(raw["neural_points.Rw2c"], np.float32)
    return agg, pts


def load_net_ray_marching_npz(path: str) -> Tuple[Dict, Dict]:
    """Read a ``{step}_net_ray_marching.npz`` into (agg_params, point_arrays)
    numpy dicts in the JAX layout (w [in,out]; unpadded [N,C] point arrays),
    ready for `from_jax_params`."""
    return import_reference_dict(dict(np.load(path)))


def load_reference_torch(path: str, opt=None) -> Tuple[Dict, Dict]:
    """A reference ``{iter}_net_ray_marching.pth`` (a torch state dict of
    the reference key names) → (agg_params, point_arrays), as
    `import_reference_dict`. Read with weights_only=True: tensors and
    containers only (the JAX package's torch.load unpickles anything)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    raw = {k: v.detach().numpy() if isinstance(v, torch.Tensor)
           else np.asarray(v) for k, v in sd.items()}
    return import_reference_dict(raw, opt)


def export_reference_npz(path: str, agg: Aggregator, point_state: Dict
                         ) -> None:
    """Write the user-facing checkpoint with reference key names: the
    aggregator's Linear layers ([out, in]) and the active points in slot
    order, [1, N, C] each."""
    out = {f"aggregator.{k}": v.detach().cpu().numpy()
           for k, v in agg.state_dict().items()}
    mask = point_state["mask"].cpu().numpy()
    order = np.argsort(~mask, kind="stable")[:int(mask.sum())]
    for ours, ref in _POINT_KEYS.items():
        if point_state.get(ours) is not None:
            out[ref] = point_state[ours].detach().cpu().numpy()[order][None]
    out["neural_points.Rw2c"] = point_state["Rw2c"].cpu().numpy()
    np.savez_compressed(path, **out)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _jax_tree(agg: Aggregator, per_param) -> Dict[str, np.ndarray]:
    """{"{branch}/{i}/w": [in,out], "{branch}/{i}/b"} from the aggregator's
    parameters mapped through per_param (a tensor → tensor function)."""
    out = {}
    for name, p in agg.named_parameters():
        branch, pos, kind = name.split(".")
        v = _np(per_param(p))
        out[f"{branch}/{int(pos) // 2}/{'w' if kind == 'weight' else 'b'}"] \
            = v.T if kind == "weight" else v
    return out


def _adam_leaves(optim: torch.optim.Adam, p: torch.Tensor):
    """(count, exp_avg, exp_avg_sq) of one parameter; zeros before the
    first update. A `trainer.Adam`'s count is read on the host."""
    st = optim.state.get(p, {})
    if "step" not in st:
        z = torch.zeros_like(p)
        return 0, z, z
    count = optim.count if isinstance(optim, trainer.Adam) \
        else int(st["step"])
    return count, st["exp_avg"], st["exp_avg_sq"]


def train_state_arrays(state: "trainer.TrainState") -> Dict[str, np.ndarray]:
    """The train state flattened under the JAX `TrainState`'s key paths
    (`pointnerf_tpu/utils/checkpoint.py::save_pytree_npz`), the point-Adam
    moments per buffer."""
    agg = state.aggregator
    out = {f".agg_params/{k}": v for k, v in _jax_tree(agg, lambda p: p).items()}
    for part, d in ((".pt_train", state.pt_train),
                    (".pt_static", state.pt_static)):
        for k, v in d.items():
            if v is not None:
                out[f"{part}/{k}"] = _np(v)
    net = dict(agg.named_parameters())
    count = _adam_leaves(state.opt_net, next(iter(net.values())))[0]
    for slot, i in ((".mu", 1), (".nu", 2)):
        tree = _jax_tree(agg, lambda p, i=i: _adam_leaves(state.opt_net,
                                                          p)[i])
        out.update({f".opt_state_net/0/{slot}/{k}": v
                    for k, v in tree.items()})
    pts_count = 0
    for k, p in state.pt_train.items():
        c, mu, nu = _adam_leaves(state.opt_pts, p)
        pts_count = max(pts_count, c)
        out[f".opt_state_pts/0/.mu/{k}"] = _np(mu)
        out[f".opt_state_pts/0/.nu/{k}"] = _np(nu)
    for chain, c in ((".opt_state_net", count), (".opt_state_pts", pts_count)):
        out[f"{chain}/0/.count"] = np.int32(c)
        out[f"{chain}/1/.count"] = np.int32(c)
    out[".step"] = np.int32(state.step)
    return out


def _nest(flat: Dict[str, np.ndarray], prefix: str):
    """The keys under `prefix/` as a nested dict (digit keys → lists)."""
    root: Dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def train_state_from_arrays(flat: Dict[str, np.ndarray], opt,
                            device="cuda") -> "trainer.TrainState":
    """Inverse of `train_state_arrays`, reading either point-Adam layout.
    Every width is checked against `opt`: the aggregator's parameters
    against `init_aggregator_params(opt)`, the point buffers' columns
    against the feature width, the trainable buffers against the *_grad
    flags."""
    want = {k: tuple(v.shape) for k, v in
            init_aggregator_params(opt, device="cpu").state_dict().items()}
    tree = _nest(flat, ".agg_params")
    got = {k: tuple(v.shape) for k, v in _net_tensors(tree).items()}
    if got != want:
        raise ValueError(f"checkpoint aggregator {got} does not match the "
                         f"options' {want}")
    pt_train = _nest(flat, ".pt_train")
    pt_static = _nest(flat, ".pt_static")
    for k in ("color", "dir", "conf"):
        if k not in pt_train:
            pt_static.setdefault(k, None)
    emb = {**pt_static, **pt_train}["embedding"]
    if emb.shape[1] != opt.point_features_dim:
        raise ValueError(f"checkpoint embedding width {emb.shape[1]}, "
                         f"options {opt.point_features_dim}")

    def chain(name):
        mu_key = f".opt_state_{name}/0/.mu"
        if mu_key in flat:               # packed point moments
            mu, nu = flat[mu_key], flat[f".opt_state_{name}/0/.nu"]
        else:
            mu, nu = _nest(flat, mu_key), _nest(flat, f".opt_state_{name}/0/.nu")
        return [SimpleNamespace(count=flat[f".opt_state_{name}/0/.count"],
                                mu=mu, nu=nu)]

    ts = SimpleNamespace(agg_params=tree, pt_train=pt_train,
                         pt_static=pt_static, opt_state_net=chain("net"),
                         opt_state_pts=chain("pts"), step=flat[".step"])
    return from_jax_train_state(ts, opt, device)


def save_checkpoint(ckpt_dir: str, step: int, state, opt,
                    best_psnr: float = 0.0, best_iter: int = 0,
                    epoch_count: int = 0,
                    extra_counters: Optional[Dict] = None) -> None:
    """Write the export, the counters and the full-resume file (reference:
    train_ft.py:955-966). extra_counters carries driver state beyond the
    reference's four (the plateau-reduced lr/plr, the PlateauTracker)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    export_reference_npz(os.path.join(ckpt_dir,
                                      f"{step}_net_ray_marching.npz"),
                         state.aggregator, state.points)
    np.savez(os.path.join(ckpt_dir, f"{step}_states.npz"),
             epoch_count=epoch_count, total_steps=step,
             best_PSNR=best_psnr, best_iter=best_iter,
             **(extra_counters or {}))
    np.savez_compressed(os.path.join(ckpt_dir, f"{step}_full.npz"),
                        **train_state_arrays(state))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step with a *_states.npz (reference: train_ft.py:542-546)."""
    steps = []
    for p in glob.glob(os.path.join(ckpt_dir, "*_states.npz")):
        m = re.match(r"^(\d+)_states\.npz$", os.path.basename(p))
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


_INT_COUNTERS = ("epoch_count", "total_steps", "best_iter", "plateau_num_bad")


def load_checkpoint(ckpt_dir: str, opt, device="cuda",
                    step: Optional[int] = None):
    """Resume: (train state on `device`, counters). step None: the newest.
    The jitter generator is reseeded from opt.seed and the step."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    flat = dict(np.load(os.path.join(ckpt_dir, f"{step}_full.npz")))
    state = train_state_from_arrays(flat, opt, device)
    state.generator.manual_seed(int(opt.seed) * 1_000_003 + state.step)
    counters = dict(np.load(os.path.join(ckpt_dir, f"{step}_states.npz")))
    counters = {k: (int(v) if k in _INT_COUNTERS else float(v))
                for k, v in counters.items()}
    return state, counters


# ------------------------------------------------ the generalizable state
_BN_JAX = {v: k for k, v in _BN_KEYS.items()}
_UP_TORCH = re.compile(r"^((?:mvsnet\.cost_regularization|probnet\.costreg)"
                       r"\.conv(?:7|9|11))\.([01])\.")


def _mvs_jax_path(key: str) -> Tuple[Optional[str], bool]:
    """An `MvsPoints` state-dict key → (its path in the JAX MVS tree,
    whether the value is transposed there); (None, False) for BatchNorm's
    step counter, which the JAX tree lacks. The inverse of
    `from_jax_mvs_params`' mapping."""
    if key.endswith("num_batches_tracked"):
        return None, False
    m = _UP_TORCH.match(key)
    if m:
        key = f"{m.group(1)}.{'conv' if m.group(2) == '0' else 'bn'}." \
            + key[m.end():]
    parts = key.split(".")
    if parts[0] == "premlp":
        weight = parts[2] == "weight"
        return f"premlp/{int(parts[1]) // 2}/{'w' if weight else 'b'}", weight
    leaf = _BN_JAX[parts[-1]] if parts[-2] == "bn" else \
        ("w" if parts[-1] == "weight" else "b")
    return "/".join(parts[:-1] + [leaf]), False


def gen_state_arrays(state) -> Dict[str, np.ndarray]:
    """A `run/train.GenTrainState` flattened under the JAX
    `GenTrainState`'s key paths (`save_pytree_npz`): agg_params,
    mvs_train (featurenet with its BatchNorm statistics, premlp, probnet),
    mvs_frozen (mvsnet), both optax chains (the MVS moments of the
    statistics, which take no gradient, are zeros) and the step."""
    agg = state.aggregator
    out = {f".agg_params/{k}": v
           for k, v in _jax_tree(agg, lambda p: p).items()}
    net = dict(agg.named_parameters())
    net_count = _adam_leaves(state.opt_net, next(iter(net.values())))[0]
    for slot, i in ((".mu", 1), (".nu", 2)):
        tree = _jax_tree(agg, lambda p, i=i: _adam_leaves(state.opt_net,
                                                          p)[i])
        out.update({f".opt_state_net/0/{slot}/{k}": v
                    for k, v in tree.items()})
    params = state.mvs_params()
    mvs_count = 0
    for k, v in state.mvs.state_dict().items():
        path, transpose = _mvs_jax_path(k)
        if path is None:
            continue
        tr = (lambda a: a.T) if transpose else (lambda a: a)
        frozen = k.startswith("mvsnet.")
        out[f"{'.mvs_frozen' if frozen else '.mvs_train'}/{path}"] = tr(_np(v))
        if frozen:
            continue
        c, mu, nu = _adam_leaves(state.opt_mvs, params[k]) if k in params \
            else (0, torch.zeros_like(v), torch.zeros_like(v))
        mvs_count = max(mvs_count, c)
        out[f".opt_state_mvs/0/.mu/{path}"] = tr(_np(mu))
        out[f".opt_state_mvs/0/.nu/{path}"] = tr(_np(nu))
    for chain, c in ((".opt_state_net", net_count),
                     (".opt_state_mvs", mvs_count)):
        out[f"{chain}/0/.count"] = np.int32(c)
        out[f"{chain}/1/.count"] = np.int32(c)
    out[".step"] = np.int32(state.step)
    return out


def _mvs_torch_tensors(tree: Dict) -> Dict[str, np.ndarray]:
    """A JAX mvs_train-shaped tree (featurenet, premlp, probnet; as numpy)
    by the port's `MvsPoints` names, premlp weights transposed to [out,
    in]."""
    flat: Dict[str, np.ndarray] = {}
    for name in ("featurenet", "probnet"):
        _conv_keys(tree.get(name, {}), f"{name}.", flat)
    flat = _up_keys(flat)
    for i, layer in enumerate(tree.get("premlp") or []):
        flat[f"premlp.{2 * i}.weight"] = np.asarray(layer["w"]).T
        flat[f"premlp.{2 * i}.bias"] = np.asarray(layer["b"])
    return flat


def from_jax_gen_state(ts, opt, device="cuda"):
    """A JAX `GenTrainState` (leaves as numpy) → the port's GenTrainState:
    the aggregator, the MVS nets (from_jax_mvs_params), both Adam chains'
    moments and counts, and the step, on `device` (the card unless the
    caller names another). The render's draw generator is seeded 0."""
    from ..run.train import make_gen_state
    layers = {name: [(np.asarray(l["w"], np.float32).T, l["b"]) for l in ls]
              for name, ls in ts.agg_params.items()}
    agg = aggregator_from_layers(layers, opt.act_type).to(device)
    mvs = from_jax_mvs_params(dict(ts.mvs_train, **ts.mvs_frozen), opt,
                              device)
    state = make_gen_state(agg, mvs, opt,
                           torch.Generator(device=device).manual_seed(0),
                           int(np.asarray(ts.step)))
    adam = _adam_of(ts.opt_state_net)
    _load_adam(state.opt_net, dict(agg.named_parameters()), adam,
               _net_tensors(adam.mu), _net_tensors(adam.nu))
    adam = _adam_of(ts.opt_state_mvs)
    _load_adam(state.opt_mvs, state.mvs_params(), adam,
               _mvs_torch_tensors(adam.mu), _mvs_torch_tensors(adam.nu))
    return state


def save_gen_npz(path: str, state) -> None:
    """Write a {steps}_gen.npz that the JAX package's `load_pytree_npz`
    reads into its GenTrainState."""
    np.savez_compressed(path, **gen_state_arrays(state))


def load_gen_npz(path: str, opt, device="cuda"):
    """Read a {steps}_gen.npz (the JAX package's `save_pytree_npz` of its
    GenTrainState, or `save_gen_npz`'s) into a GenTrainState on `device`.
    The aggregator's widths are checked against `opt`."""
    flat = dict(np.load(path))
    want = {k: tuple(v.shape) for k, v in
            init_aggregator_params(opt, device="cpu").state_dict().items()}
    agg = _nest(flat, ".agg_params")
    got = {k: tuple(v.shape) for k, v in _net_tensors(agg).items()}
    if got != want:
        raise ValueError(f"checkpoint aggregator {got} does not match the "
                         f"options' {want}")

    def chain(name):
        pre = f".opt_state_{name}/0"
        return [SimpleNamespace(count=flat[f"{pre}/.count"],
                                mu=_nest(flat, f"{pre}/.mu"),
                                nu=_nest(flat, f"{pre}/.nu"))]

    ts = SimpleNamespace(agg_params=agg, mvs_train=_nest(flat, ".mvs_train"),
                         mvs_frozen=_nest(flat, ".mvs_frozen"),
                         opt_state_net=chain("net"),
                         opt_state_mvs=chain("mvs"), step=flat[".step"])
    return from_jax_gen_state(ts, opt, device)
