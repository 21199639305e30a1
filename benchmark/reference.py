"""The plain reference of one RankAAE trial: float32 PyTorch, one trial at a
time, no kernel, no stacking, no fused block.

It follows the published RankAAE training protocol
(``sc/clustering/trainer.py`` and ``sc/utils/functions.py`` of the
reference package): the faithful batch of five optimizer steps
(adversarial, Kendall, reconstruction, mutual information, smoothness)
with AdamW, and the validation pass with its five quality metrics (the
Shapiro-Wilk W and the Spearman correlations from scipy).  Weights are a
dict of tensors named as the modules' state dicts name them; a
:class:`Draws` object hands out the random draws by site.

This file is the protocol, the same for every form.  The model (the
encoder, the decoder and the discriminator of ``sc/clustering/model.py``)
comes from a model module: a Python file under ``benchmark/`` that a
configuration file names under its ``reference`` key, loaded by path
(``benchmark/harness.py::load_model``).  Every model module gives the
functions of :data:`MODEL_INTERFACE`, each taking the configuration's keys
``cfg`` first:

* ``layout(cfg)``: ``{"enc"|"dec"|"dis": [(name, shape, init), ...]}``, the
  tensors of each module in the order :func:`make_weights` draws them
  (:class:`Layout` collects them);
* ``encoder(cfg, n, spec)``: (B, dim_in) spectra -> (B, nstyle) styles, with
  ``n`` a :class:`Net` over the encoder's weights;
* ``decoder(cfg, n, z)``: (B, nstyle) -> (B, dim_out) spectra;
* ``discriminator(cfg, n, x, beta)``: (B, nstyle) -> (B, 1) logits, behind
  the gradient reversal of strength ``beta`` (:func:`grad_reverse`);
* ``adversarial_logits(cfg, n, z_real, styles, beta) -> (real, fake)``: the
  adversarial step's logits of the prior's draws and of the styles, each
  (B, 1), in as many passes as the discriminator needs (one where it keeps
  no batch statistics, two where it does);
* ``macs(cfg)``: the encoder's, the decoder's and the discriminator's
  multiply-adds per spectrum, for ``benchmark/flops.py::epoch_flops``.

Nothing here or in a model module imports the program under test.  Set
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False before running it on a GPU
(:func:`float32_only`).
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from typing import Dict, List, Tuple

import numpy as np
import scipy.stats
import torch
import torch.nn.functional as F

#: what every model module gives (the module docstring says what each does)
MODEL_INTERFACE = ("layout", "encoder", "decoder", "discriminator", "adversarial_logits", "macs")
#: the quality metrics' weights (trainer.py:35-36)
METRIC_WEIGHTS = (1.0, -1.0, -0.01, -1.0, -1.0)
#: optimizer -> (modules it steps, lr ratio key, betas scaled by this key)
#: (trainer.py:333-397); every one is AdamW
OPTIMIZERS = {
    "adversarial": (("dis", "enc"), "lr_ratio_dis", "dis_beta"),
    "correlation": (("enc",), "lr_ratio_Corr", None),
    "reconstruction": (("enc", "dec"), "lr_ratio_Reconn", None),
    "mutual_info": (("enc", "dec"), "lr_ratio_Mutual", None),
    "smoothness": (("dec",), "lr_ratio_Smooth", None),
}
ADAM_EPS = 1e-8
BN_MOMENTUM, BN_EPS = 0.1, 1e-5


def float32_only() -> None:
    """True float32 matmuls and convolutions on a GPU (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------- #
# the weights' layout
# --------------------------------------------------------------------------- #

class Layout:
    """Collects (name, shape, init) of a module's tensors; init is a float
    bound b for U(-b, b), or ("fill", v) for a constant."""

    def __init__(self):
        self.entries: List[Tuple[str, tuple, object]] = []

    def linear(self, name, n_in, n_out):
        b = 1.0 / math.sqrt(n_in)
        self.entries += [(f"{name}.weight", (n_out, n_in), b), (f"{name}.bias", (n_out,), b)]

    def conv(self, name, c_in, c_out, k, groups=1):
        b = 1.0 / math.sqrt(c_in // groups * k)
        self.entries += [(f"{name}.weight", (c_out, c_in // groups, k), b),
                         (f"{name}.bias", (c_out,), b)]

    def conv_t(self, name, c_in, c_out, k, groups=1):
        # a transposed convolution's weight is (in, out / groups, k); torch
        # takes its fan-in from dim 1
        b = 1.0 / math.sqrt(c_out // groups * k)
        self.entries += [(f"{name}.weight", (c_in, c_out // groups, k), b),
                         (f"{name}.bias", (c_out,), b)]

    def prelu(self, name, c):
        self.entries.append((f"{name}.weight", (c,), ("fill", 0.01)))

    def bn(self, name, c):
        self.entries += [(f"{name}.running_mean", (c,), ("fill", 0.0)),
                         (f"{name}.running_var", (c,), ("fill", 1.0))]


def make_weights(lay, trials: int, generator: torch.Generator, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every trial's initial weights of the layout ``lay`` (a model module's
    ``layout(cfg)``), stacked (T, ...), in one draw of uniforms from
    ``generator``, role by role and entry by entry in the layout's order:
    U(+-1/sqrt(fan_in)) for the weights and biases (torch's default), PReLU
    slopes 0.01, BatchNorm statistics (0, 1)."""
    sizes = [trials * math.prod(shape) for role in lay for _, shape, init in lay[role]
             if not isinstance(init, tuple)]
    u = torch.rand(sum(sizes), generator=generator, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for role, entries in lay.items():
        out[role] = {}
        for name, shape, init in entries:
            if isinstance(init, tuple):
                out[role][name] = torch.full((trials, *shape), init[1], device=device)
                continue
            n = trials * math.prod(shape)
            out[role][name] = u[at:at + n].view(trials, *shape).mul(init)
            at += n
    return out


# --------------------------------------------------------------------------- #
# the random draws
# --------------------------------------------------------------------------- #

class Draws:
    """One trial's recorded draws: normal draws by site name, each site's in
    the order drawn; dropout keep-masks in the order drawn."""

    def __init__(self, records):
        self.normal_q = defaultdict(deque)
        self.mask_q = deque()
        for kind, name, value in records:
            if kind == "normal":
                self.normal_q[name].append(value)
            elif kind == "mask":
                self.mask_q.append(value)

    def normal(self, name, shape):
        if not self.normal_q[name]:
            raise DrawMismatch(f"no recorded draw {name!r} of shape {tuple(shape)}")
        x = self.normal_q[name].popleft()
        if tuple(x.shape) != tuple(shape):
            raise DrawMismatch(f"draw {name!r}: recorded {tuple(x.shape)}, needed {tuple(shape)}")
        return x

    def mask(self, shape):
        if not self.mask_q:
            raise DrawMismatch(f"no recorded keep-mask of shape {tuple(shape)}")
        m = self.mask_q.popleft()
        if tuple(m.shape) != tuple(shape):
            raise DrawMismatch(f"keep-mask: recorded {tuple(m.shape)}, needed {tuple(shape)}")
        return m


class DrawMismatch(RuntimeError):
    """The program drew other sites or shapes than the reference needs."""


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #

class Net:
    """One module's weights ``w`` (name -> tensor) and whether it runs in
    train mode, with the draws it takes its masks from."""

    def __init__(self, w, train: bool, draws: Draws = None, dropout: float = 0.0):
        self.w, self.train, self.draws, self.dropout = w, train, draws, dropout

    def bn(self, name, x):
        # BatchNorm1d(affine=False): batch statistics in train mode, running
        # statistics updated in place with the unbiased variance
        return F.batch_norm(x, self.w[f"{name}.running_mean"], self.w[f"{name}.running_var"],
                            None, None, self.train, BN_MOMENTUM, BN_EPS)

    def prelu(self, name, x):
        return F.prelu(x, self.w[f"{name}.weight"])

    def linear(self, name, x):
        return F.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def conv(self, name, x, stride=1, padding=0, groups=1):
        return F.conv1d(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"], stride, padding,
                        1, groups)

    def conv_t(self, name, x, stride, groups=1):
        return F.conv_transpose1d(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"], stride,
                                  0, 0, groups)

    def drop(self, x):
        if not self.train or self.dropout == 0.0:
            return x
        keep = 1.0 - self.dropout
        return torch.where(self.draws.mask(x.shape), x / keep, torch.zeros_like(x))


class _Reverse(torch.autograd.Function):
    """Gradient reversal (model.py:8-22): identity forward, -beta * g back."""

    @staticmethod
    def forward(ctx, x, beta):
        ctx.beta = beta
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.beta * g, None


def grad_reverse(x, beta):
    return _Reverse.apply(x, beta)


# --------------------------------------------------------------------------- #
# losses (functions.py:37-219)
# --------------------------------------------------------------------------- #

def kendall_loss(d, s, activate: bool):
    """The Kendall constraint over all ordered pairs (functions.py:37-79)."""
    target = torch.sign(d[:, None, :] - d[None, :, :])
    product = (s[:, None, :] - s[None, :, :]) * target
    if activate:
        n_same = torch.clamp((product > 0).sum(dim=(0, 1)), min=1).float()
        n_opp = torch.clamp((product < 0).sum(dim=(0, 1)), min=1).float()
        w = (n_opp / torch.maximum(n_same, n_opp)).detach()
        product = torch.where(product > 0, product * w, product)
    b, k = s.shape
    return -product.sum() / ((b * b - b) * k)


def recon_loss(spec_in, spec_out, flex: bool, weight: float):
    """MSE, or with the flex target: a per-spectrum amplitude ratio pulled to
    1, then detached, clamped to [0.7, 1.3] and applied to the target
    (functions.py:81-107)."""
    if not flex:
        return F.mse_loss(spec_out, spec_in)
    scale = spec_out.mean(dim=-1).abs() / spec_in.mean(dim=-1).abs()
    penalty = torch.mean((scale - 1.0) ** 2) * weight
    return penalty + F.mse_loss(spec_out, spec_in * scale.detach().clamp(0.7, 1.3)[:, None])


def smooth_loss(spec_out, size: int = 17, sigma: float = 3.0):
    """MSE between the spectra and their Gaussian-smoothed selves, replicate
    padding (functions.py:194-212)."""
    grid = torch.arange(size, dtype=spec_out.dtype, device=spec_out.device)
    k = torch.exp(-0.5 * ((grid - (size - 1) / 2.0) / sigma) ** 2)
    k = k / k.sum()
    pad = (size - 1) // 2
    smooth = F.conv1d(F.pad(spec_out[:, None, :], (pad, pad), mode="replicate"),
                      k.view(1, 1, size))[:, 0, :]
    return F.mse_loss(spec_out, smooth)


def adversarial_loss(logits_real, logits_fake):
    return (F.binary_cross_entropy_with_logits(logits_real, torch.ones_like(logits_real))
            + F.binary_cross_entropy_with_logits(logits_fake, torch.zeros_like(logits_fake)))


# --------------------------------------------------------------------------- #
# AdamW (torch.optim.AdamW's update; bias corrections in float32)
# --------------------------------------------------------------------------- #

class AdamW:
    """One optimizer over named leaves of one trial: moments ``mu``, ``nu``
    by leaf name, step count ``count``."""

    def __init__(self, names, lr, betas, wd):
        self.names, self.lr, self.betas, self.wd = list(names), lr, betas, wd
        self.mu, self.nu, self.count = {}, {}, 0

    def step(self, params, grads):
        b1, b2 = self.betas
        self.count += 1
        t = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        with torch.no_grad():
            for name in self.names:
                p, g = params[name], grads[name]
                m = self.mu.setdefault(name, torch.zeros_like(p))
                v = self.nu.setdefault(name, torch.zeros_like(p))
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.mul_(1.0 - self.lr * self.wd)
                p.sub_(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))


def betas_of(cfg, opt):
    """Optimizer ``opt``'s (beta1, beta2) (trainer.py:369,377,386)."""
    beta_key = OPTIMIZERS[opt][2]
    if beta_key is None:
        return 0.9, 0.999
    b = cfg[beta_key]
    return 0.9 * b, 0.009 * b + 0.99


def make_optimizers(cfg, names_of):
    """The five optimizers of a faithful GRL batch; ``names_of[role]`` the
    leaf names of a module."""
    return {opt: AdamW([f"{r}.{n}" for r in roles for n in names_of[r]],
                       cfg[ratio] * cfg["lr_base"], betas_of(cfg, opt), cfg["weight_decay"])
            for opt, (roles, ratio, _) in OPTIMIZERS.items()}


# --------------------------------------------------------------------------- #
# one trial
# --------------------------------------------------------------------------- #

def alpha_schedule(cfg, epoch: int) -> float:
    """The GRL strength ramp (functions.py:214-219)."""
    p = epoch / cfg["max_epoch"]
    return (2.0 / (1.0 + math.exp(-1.0e4 / cfg["alpha_flat_step"] * p)) - 1.0) * cfg["alpha_limit"]


#: the faithful batch's five steps in order: (step, optimizer, loss name)
STEPS = (("adversarial", "adversarial", "dis"), ("correlation", "correlation", "aux"),
         ("reconstruction", "reconstruction", "recon"), ("mutual_info", "mutual_info", "mi"),
         ("smoothness", "smoothness", "smooth"))


class Trial:
    """One trial of the model module ``model``: its weights and statistics
    ``w[role][name]`` (float32, on one device) and its five optimizers,
    each optionally started from ``moments[opt] = (count, mu, nu)``."""

    def __init__(self, cfg, weights, device, moments=None, *, model):
        self.cfg, self.device, self.model = cfg, device, model
        self.w = {role: {n: t.detach().clone().to(device) for n, t in sd.items()}
                  for role, sd in weights.items()}
        self.params = {}
        for role, sd in self.w.items():
            for n, t in sd.items():
                if not n.endswith(("running_mean", "running_var")):
                    t.requires_grad_(True)
                    self.params[f"{role}.{n}"] = t
        names_of = {role: [n for n in sd if not n.endswith(("running_mean", "running_var"))]
                    for role, sd in self.w.items()}
        self.opts = make_optimizers(cfg, names_of)
        for opt, (count, mu, nu) in (moments or {}).items():
            o = self.opts[opt]
            o.count = count
            o.mu = {n: mu[n].clone().to(device) for n in o.names}
            o.nu = {n: nu[n].clone().to(device) for n in o.names}

    def nets(self, train, draws):
        c = self.cfg
        return (Net(self.w["enc"], train, draws, c["dropout_rate"]),
                Net(self.w["dec"], train, draws, c["dropout_rate"]),
                Net(self.w["dis"], train, draws, c["dis_dropout_rate"]))

    def _update(self, opt, loss):
        o = self.opts[opt]
        leaves = [self.params[n] for n in o.names]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(o.names, leaves, grads)}
        o.step(self.params, grads)
        return grads

    def begin(self, spec, draws: Draws):
        """A batch's first draws (trainer.py:112): the noisy input and the
        prior's draws for the adversarial step."""
        cfg = self.cfg
        self.spec_in = spec + draws.normal("spec_noise", spec.shape) * cfg["spec_noise"]
        self.z_real = draws.normal("z_real", (cfg["batch_size"], cfg["nstyle"]))

    def step(self, name, aux, epoch: int, draws: Draws):
        """One of :data:`STEPS` of the faithful batch (trainer.py:103-204)
        begun by :meth:`begin`: its train-mode forwards, its loss, the
        gradient over its optimizer's leaves and the AdamW update.  Returns
        the loss (a float) and the gradients by leaf name."""
        cfg, spec_in, model = self.cfg, self.spec_in, self.model
        enc, dec, dis = self.nets(True, draws)
        E = lambda x: model.encoder(cfg, enc, x)    # noqa: E731
        D = lambda z: model.decoder(cfg, dec, z)    # noqa: E731
        if name == "adversarial":
            # GRL (functions.py:109-132): the encoder's styles as fakes, the
            # prior's draws as reals; the dead decode updates statistics only
            styles = E(spec_in)
            with torch.no_grad():
                D(styles)
            real, fake = model.adversarial_logits(cfg, dis, self.z_real, styles,
                                                  alpha_schedule(cfg, epoch))
            loss = adversarial_loss(real[:, 0], fake[:, 0])
        elif name == "correlation":
            loss = kendall_loss(aux, E(spec_in)[:, :cfg["n_aux"]], cfg["kendall_activation"])
        elif name == "reconstruction":
            loss = recon_loss(spec_in, D(E(spec_in)), cfg["use_flex_spec_target"],
                              cfg["flex_scale_weight"])
        elif name == "mutual_info":
            with torch.no_grad():
                E(spec_in)                          # the unused re-encode: statistics
            z_sample = draws.normal("z_sample", (spec_in.shape[0], cfg["nstyle"]))
            loss = F.mse_loss(E(D(z_sample)), z_sample)
        elif name == "smoothness":
            with torch.no_grad():
                styles = E(spec_in)
            loss = smooth_loss(D(styles))
        else:
            raise ValueError(f"no step {name!r}")
        return float(loss.detach()), self._update(name, loss)

    @torch.no_grad()
    def validate(self, val_spec, val_aux, epoch: int, draws: Draws, avg_mi: float):
        """The validation pass (trainer.py:206-304) in eval mode; returns its
        losses, the amplitude gain and the five quality metrics."""
        cfg, model = self.cfg, self.model
        enc, dec, dis = self.nets(False, draws)
        z = model.encoder(cfg, enc, val_spec)
        out = model.decoder(cfg, dec, z)
        ratio = out.mean(dim=-1).abs() / val_spec.mean(dim=-1).abs()
        r = torch.sort(ratio).values
        n = r.shape[0]
        gain = (r[(n - 1) // 2] + r[n // 2]) / 2.0
        z_sample = draws.normal("z_val", (n, cfg["nstyle"]))
        mi = F.mse_loss(model.encoder(cfg, enc, model.decoder(cfg, dec, z_sample)), z_sample)
        z_real = draws.normal("z_real_val", (cfg["batch_size"], cfg["nstyle"]))
        beta = alpha_schedule(cfg, epoch)
        dis_v = adversarial_loss(model.discriminator(cfg, dis, z_real, beta)[:, 0],
                                 model.discriminator(cfg, dis, z, beta)[:, 0])
        out_v = {"recon": F.mse_loss(out, val_spec),
                 "aux": kendall_loss(val_aux, z[:, :cfg["n_aux"]], cfg["kendall_activation"]),
                 "smooth": smooth_loss(out), "mi": mi, "dis": dis_v, "gain": gain}
        out_v = {k: float(v) for k, v in out_v.items()}
        zz = z.double().cpu().numpy()
        k = zz.shape[1]
        shapiro = min(scipy.stats.shapiro(zz[:, i]).statistic for i in range(k))
        spearman = max(abs(scipy.stats.spearmanr(zz[:, i], zz[:, j]).statistic)
                       for i in range(k) for j in range(i + 1, k))
        metrics = (shapiro, out_v["recon"], avg_mi, spearman, out_v["aux"])
        out_v["metrics"] = [float(m) for m in metrics]
        out_v["combined"] = -float(np.dot(METRIC_WEIGHTS, metrics))
        return out_v
