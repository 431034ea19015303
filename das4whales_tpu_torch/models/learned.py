"""Learned call detector in PyTorch: a small CNN classifying log-spectrogram
windows (the fourth detector family; the port's copy of
``das4whales_tpu.models.learned``).

* Features: the port's STFT magnitude (``ops.spectral.stft_magnitude``,
  engine :data:`FEATURE_STFT_ENGINE`, ``"fused"``: the ``fused_stft``
  CUDA kernel on a card tensor, its plain version on a CPU tensor), the bins below
  ``fmax_bin``, ``log1p(mag * 1e6)``, overlapping windows of
  ``win_frames`` frames every ``win_stride``, each standardised over its
  own window.
* Classifier: :class:`LearnedCNN`, two stride-2 3x3 convolutions with the
  JAX package's ``padding="SAME"`` (asymmetric at stride 2: nothing
  before, the rest after), tanh-approximated GELU (``jax.nn.gelu``'s
  default), a global mean and a linear head. The convolutions are
  cuDNN's on the card, TF32 off (``utils.device.disable_tf32``).
* Detection: the sigmoid scores of every (channel, window), read to the
  host once a call, then the threshold and a per-channel non-maximum
  suppression on the host — the same ``picks`` contract as the other
  families.
* Training: ``fit`` pools the windows of synthetic scenes on the host,
  rebalances and shuffles them as the JAX package does (the same numpy
  draws, so the same batch order), and steps ``torch.optim.AdamW`` in
  place of ``optax.adamw``.

Parameters cross between the packages as JAX's pytree of numpy arrays
(``convert.learned_params_from_arrays`` / ``learned_params_to_arrays``):
conv weights HWIO there, OIHW here. ``save_params`` writes the JAX
package's ``.npz`` layout, so a file saved by either package loads in the
other. ``load_pretrained("fin_cnn")`` reads the port's own copy of the
shipped model (``models/pretrained/fin_cnn.npz``).

Over a device mesh (``parallel.mesh``, one rank a device; every rank
calls these with the same arguments): :func:`make_sharded_train_step`
averages each step's gradients over the batch axis with one ``psum``
before the AdamW step (the parameters stay replicated, bitwise equal on
every rank), ``fit(mesh=...)`` trains data-parallel on it, and
:func:`make_sharded_inference` scores this rank's channel slice of a
block with no collective.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import spectral
from ..utils import artifacts
from ..utils.device import resolve_device
from ..utils.views import cached_shallow_view

#: the STFT engine the learned features ride: the ``fused_stft`` kernel.
#: The family takes no engine request (``DAS4WHALES_STFT_ENGINE`` and
#: ``"auto"`` are the spectro detector's, ``ops.mxu.resolve_stft_engine_ab``).
FEATURE_STFT_ENGINE = "fused"


@dataclass(frozen=True)
class LearnedConfig:
    """Feature, model and optimisation hyperparameters (the JAX
    package's fields and defaults)."""

    nfft: int = 128          # STFT size (fs=200 -> 1.56 Hz bins)
    hop: int = 32            # STFT hop (0.16 s at 200 Hz)
    win_frames: int = 8      # frames per classified window (~1.3 s)
    win_stride: int = 4      # window stride in frames (~0.64 s)
    fmax_bin: int = 32       # keep bins [0, fmax_bin) (~50 Hz at fs=200)
    features: tuple = (16, 32)
    lr: float = 1e-2
    weight_decay: float = 1e-4
    # the convolutions' input width: "bfloat16" convolves bf16 inputs and
    # weights (parameters stay float32); "float32" is the default
    compute_dtype: str = "float32"


def _as_input(block, device=None) -> torch.Tensor:
    """A ``[C, T]`` block as float32 on its device: a tensor stays where
    it is; anything else (numpy, a JAX array) goes to ``device``."""
    if isinstance(block, torch.Tensor):
        return block.to(torch.float32)
    arr = np.asarray(block, np.float32)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(resolve_device(device))


def window_centers(n_win: int, cfg: LearnedConfig) -> np.ndarray:
    """Window-center SAMPLE indices for ``n_win`` windows — the one
    definition shared by feature extraction and pick assembly (numpy on
    the host, truncated as the JAX package truncates)."""
    idx = (np.arange(n_win)[:, None] * cfg.win_stride
           + np.arange(cfg.win_frames)[None, :])
    return (idx.mean(axis=1) * cfg.hop).astype(np.int64)


def window_features(block, cfg: LearnedConfig, engine: str = FEATURE_STFT_ENGINE, *,
                    device=None, stage_hook: Callable[[str], None] | None = None):
    """``[C, T]`` strain block -> per-channel log-spectrogram windows.

    Returns ``(windows [C, n_win, F, W], centers [n_win])`` where
    ``centers`` are window-center SAMPLE indices. Each window is
    standardised over its own bins and frames (population std, floored at
    1e-6), which makes the classifier amplitude-invariant. A tensor block
    stays on its device; any other block goes to ``device`` (None: the
    card). ``stage_hook`` is called after ``stft`` and ``features``."""
    x = _as_input(block, device)
    mag = spectral.stft_magnitude(x, cfg.nfft, cfg.hop, engine=engine)
    if stage_hook is not None:
        stage_hook("stft")
    logm = torch.log1p(mag[:, : cfg.fmax_bin, :] * 1e6)   # strain ~1e-9..1e-6
    del mag
    n_frames = logm.shape[-1]
    n_win = max(0, (n_frames - cfg.win_frames) // cfg.win_stride + 1)
    if n_win:
        win = logm.unfold(-1, cfg.win_frames, cfg.win_stride).permute(0, 2, 1, 3)
        mu = win.mean(dim=(-2, -1), keepdim=True)
        sd = win.std(dim=(-2, -1), keepdim=True, correction=0)
        win = (win - mu) / sd.clamp_min(1e-6)             # [C, n_win, F, W]
    else:
        win = logm.new_zeros((logm.shape[0], 0, logm.shape[1], cfg.win_frames))
    if stage_hook is not None:
        stage_hook("features")
    return win, window_centers(n_win, cfg)


def window_labels(scene, centers: np.ndarray, cfg: LearnedConfig) -> np.ndarray:
    """``[C, n_win]`` {0,1} labels: window center within half a window of
    any call's arrival-plus-half-duration at that channel (the forward
    model of ``eval.arrival_times``)."""
    from ..eval import arrival_times

    half = (cfg.win_frames * cfg.hop) / 2.0 / scene.fs
    labels = np.zeros((scene.nx, len(centers)), bool)
    t_centers = np.asarray(centers) / scene.fs            # [n_win]
    for call in scene.calls:
        arr = arrival_times(call, scene) + call.duration / 2.0   # [C]
        labels |= np.abs(t_centers[None, :] - arr[:, None]) <= half
    return labels.astype(np.float32)


def _same_pad(n: int) -> tuple:
    """``(before, after)`` padding of XLA's ``"SAME"`` for a 3-tap stride-2
    convolution over ``n`` samples: the output has ``ceil(n / 2)``
    samples and the padding's odd half goes after."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


class LearnedCNN(nn.Module):
    """The classifier: per feature width a 3x3 stride-2 convolution (SAME
    padding as XLA pads it) and a tanh GELU, then the mean over the map
    and a linear head. Parameters mirror the JAX pytree: ``convs[i]``
    holds ``conv{i}`` (weights OIHW), ``head_w [C]`` and the 0-d
    ``head_b`` hold ``head``."""

    def __init__(self, features: Sequence[int] = (16, 32)):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        convs, c_in = [], 1
        for c_out in self.features:
            convs.append(nn.Conv2d(c_in, c_out, 3, stride=2, padding=0))
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.head_w = nn.Parameter(torch.zeros(c_in))
        self.head_b = nn.Parameter(torch.zeros(()))

    def forward(self, windows: torch.Tensor, compute_dtype: str = "float32") -> torch.Tensor:
        return cnn_logits(self, windows, compute_dtype)


def cnn_logits(model: LearnedCNN, windows: torch.Tensor,
               compute_dtype: str = "float32") -> torch.Tensor:
    """``[B, F, W]`` standardised windows -> ``[B]`` call logits.

    ``compute_dtype="bfloat16"`` convolves bf16 inputs and weights; the
    convolution's result is rounded to bf16 (torch returns the input's
    type), the bias and GELU are float32 and the activations go back to
    bf16, as the JAX package's ``preferred_element_type`` route except
    for that one rounding."""
    bf16 = compute_dtype == "bfloat16"
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
    x = windows.unsqueeze(1)                              # [B, 1, F, W]
    x = x.to(torch.bfloat16) if bf16 else x.to(torch.float32)
    for conv in model.convs:
        ph, pw = _same_pad(x.shape[-2]), _same_pad(x.shape[-1])
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        if bf16:
            y = F.conv2d(x, conv.weight.to(torch.bfloat16), None, stride=2).float()
            y = y + conv.bias.view(1, -1, 1, 1)
        else:
            y = F.conv2d(x, conv.weight, conv.bias, stride=2)
        del x
        x = F.gelu(y, approximate="tanh")
        del y
        if bf16:
            x = x.to(torch.bfloat16)
    feat = x.float().mean(dim=(2, 3))                     # [B, C]
    return feat @ model.head_w + model.head_b


def score_windows(model: LearnedCNN, win_flat: torch.Tensor,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """``[B, F, W]`` windows -> ``[B]`` sigmoid call scores (no gradient)."""
    with torch.no_grad():
        return torch.sigmoid(cnn_logits(model, win_flat, compute_dtype))


def bce_loss(model: LearnedCNN, windows: torch.Tensor, labels: torch.Tensor,
             compute_dtype: str = "float32") -> torch.Tensor:
    """Mean binary cross-entropy with logits, in the JAX package's stable
    form ``max(l, 0) - l y + log1p(exp(-|l|))``."""
    logits = cnn_logits(model, windows, compute_dtype)
    loss = (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss.mean()


def _init_cnn_params(rng: np.random.Generator, cfg: LearnedConfig) -> dict:
    """The JAX package's initial parameter pytree as numpy float32 (He
    normal convolutions, zero biases, a 0.01-scaled head): the same draws
    in the same order, so both packages start from the same parameters."""
    params = {}
    c_in = 1
    for li, c_out in enumerate(cfg.features):
        fan_in = 3 * 3 * c_in
        params[f"conv{li}"] = {
            "w": (rng.standard_normal((3, 3, c_in, c_out))
                  * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "b": np.zeros((c_out,), np.float32),
        }
        c_in = c_out
    params["head"] = {
        "w": (rng.standard_normal((c_in,)) * 0.01).astype(np.float32),
        "b": np.zeros((), np.float32),
    }
    return params


def _as_model(params, cfg: LearnedConfig) -> LearnedCNN:
    """A :class:`LearnedCNN` or JAX's parameter pytree (numpy or any
    array type) -> a :class:`LearnedCNN` of its own (never the caller's
    module, which may go on training)."""
    if isinstance(params, LearnedCNN):
        return copy.deepcopy(params)
    from ..convert import learned_params_from_arrays

    return learned_params_from_arrays(params, {"features": cfg.features})


def init_train_state(cfg: LearnedConfig, seed: int = 0, device=None):
    """``(model, optimizer)`` for AdamW training on ``device`` (None: the
    card): the JAX package's initial parameters and ``optax.adamw``'s
    settings — ``cfg.lr``, betas 0.9 / 0.999, eps 1e-8, decay
    ``cfg.weight_decay`` on every parameter. The CNN is fully
    convolutional with a global pool, so its parameters do not depend on
    the input shape."""
    dev = resolve_device(device)
    model = _as_model(_init_cnn_params(np.random.default_rng(seed), cfg), cfg).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    return model, opt


def train_step(model: LearnedCNN, opt: torch.optim.Optimizer, windows, labels,
               compute_dtype: str = "float32"):
    """One AdamW step on a ``[B, F, W]`` batch, in place; returns
    ``(model, opt, loss)`` with the loss of the batch before the step
    (a 0-d tensor on the model's device)."""
    opt.zero_grad(set_to_none=True)
    loss = bce_loss(model, windows, labels, compute_dtype)
    loss.backward()
    opt.step()
    return model, opt, loss.detach()


def make_sharded_train_step(mesh, batch_axis: str = "batch"):
    """Data-parallel training over ``mesh``'s ``batch_axis``: returns
    ``(step, put)``. ``put(windows, labels)`` places this rank's slice of
    a host batch (its block of the batch axis) on its device; ``step`` is
    :func:`train_step` with the gradients averaged over the axis before
    the AdamW step — one ``psum`` of the flattened gradients divided by
    the axis size. The shards are equal, so that is the gradient of the
    global batch's mean loss (what GSPMD computes in JAX); the parameters
    stay replicated and the returned loss is the global mean."""
    from ..parallel import collectives as coll
    from ..parallel.mesh import Sharding

    sh = Sharding(mesh, (batch_axis,))
    p = mesh.axis_size(batch_axis)

    def put(windows, labels):
        return (sh.place(np.asarray(windows, np.float32)),
                sh.place(np.asarray(labels, np.float32)))

    def step(model: LearnedCNN, opt: torch.optim.Optimizer, windows, labels,
             compute_dtype: str = "float32"):
        opt.zero_grad(set_to_none=True)
        loss = bce_loss(model, windows, labels, compute_dtype)
        loss.backward()
        params = [q for q in model.parameters() if q.grad is not None]
        flat = torch.cat([q.grad.reshape(-1) for q in params])
        flat = coll.psum(flat, mesh, batch_axis) / p
        for q, g in zip(params, flat.split([q.numel() for q in params])):
            q.grad.copy_(g.view_as(q.grad))
        opt.step()
        return model, opt, coll.psum(loss.detach(), mesh, batch_axis) / p

    step.mesh = mesh
    return step, put


def make_sharded_inference(params, cfg: LearnedConfig, mesh, channel_axis: str = "channel"):
    """Channel-sharded scoring over ``mesh``: returns ``(score_fn, put)``.
    ``put(block)`` places this rank's channel slice of a host ``[C, T]``
    block on its device (``parallel.mesh.shard_block``); ``score_fn``
    maps it to this rank's ``[C/P, n_win]`` sigmoid scores. Channels are
    independent end to end, so there is no collective; the features take
    the STFT engine ``"rfft"``, as the JAX package's sharded inference
    does. The threshold and NMS stay on the host
    (``LearnedDetector.picks_from_scores``)."""
    from ..parallel.mesh import shard_block

    model = _as_model(params, cfg).to(mesh.device).eval()

    def score_fn(block):
        win, _ = window_features(block, cfg, engine="rfft", device=mesh.device)
        C, n_win = win.shape[0], win.shape[1]
        flat = win.reshape(C * n_win, *win.shape[-2:])
        del win
        return score_windows(model, flat, cfg.compute_dtype).reshape(C, n_win)

    def put(block):
        return shard_block(np.asarray(block, np.float32), mesh, channel_axis)

    score_fn.mesh = mesh
    return score_fn, put


def fit(cfg: LearnedConfig, scenes: Sequence, epochs: int = 8, batch: int = 1024,
        seed: int = 0, mesh=None, log_every: int = 0, device=None):
    """Train on synthetic scenes (``io.synth.SyntheticScene``) on
    ``device`` (None: the card); returns ``(model, history)``, the mean
    loss of each epoch. Features are computed once, outside the
    gradient; the windows of every scene are pooled on the host,
    positives duplicated to about 1:4 and the pool shuffled each epoch
    with the JAX package's numpy draws, so the batches are the same.
    With ``mesh`` (every rank calls ``fit`` with the same arguments) the
    batches run data-parallel over its ``batch`` axis
    (:func:`make_sharded_train_step`) on the mesh's device, the batch
    rounded to a multiple of the mesh's size as in JAX; every rank sees
    the same global batches and returns the same model."""
    from ..io.synth import synthesize_scene

    dev = mesh.device if mesh is not None else resolve_device(device)
    xs, ys = [], []
    for scene in scenes:
        win, centers = window_features(synthesize_scene(scene), cfg, device=dev)
        lab = window_labels(scene, centers, cfg)
        xs.append(win.reshape(-1, *win.shape[-2:]).cpu().numpy())
        ys.append(lab.reshape(-1))
        del win
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    pos = np.nonzero(y > 0.5)[0]
    if len(pos):  # rebalance ~1:4
        dup = max(0, len(y) // (4 * len(pos)) - 1)
        if dup:
            x = np.concatenate([x] + [x[pos]] * dup)
            y = np.concatenate([y] + [y[pos]] * dup)

    model, opt = init_train_state(cfg, seed, device=dev)
    if mesh is not None:
        step, put = make_sharded_train_step(mesh)
    else:
        step = train_step

        def put(w, lab):
            return torch.from_numpy(w).to(dev), torch.from_numpy(lab).to(dev)
    bmult = mesh.size if mesh is not None else 1
    batch = min(batch, (len(y) // bmult) * bmult)
    if batch <= 0:
        raise ValueError(f"pool of {len(y)} windows cannot fill one batch over {bmult} "
                         "devices — use more or larger scenes")
    batch = -(-batch // bmult) * bmult
    rng = np.random.default_rng(seed)
    history = []
    n = len(y)
    for ep in range(epochs):
        order = rng.permutation(n)
        losses = []
        for s in range(0, n - batch + 1, batch):
            sel = order[s : s + batch]
            wb, lb = put(x[sel], y[sel])
            model, opt, loss = step(model, opt, wb, lb, cfg.compute_dtype)
            losses.append(float(loss))
        history.append(float(np.mean(losses)) if losses else float("nan"))
        if log_every and (ep + 1) % log_every == 0:
            print(f"epoch {ep + 1}: loss {history[-1]:.4f}")
    return model, history


def save_params(path: str, params, cfg: LearnedConfig) -> str:
    """Persist parameters (a :class:`LearnedCNN` or JAX's pytree) and the
    configuration as one ``.npz`` in the JAX package's layout — flat
    ``"conv0.w"``-style keys, HWIO convolution weights, ``__cfg__``,
    ``__features__`` and ``__compute_dtype__`` — through the durable
    writer (``utils.artifacts.atomic_file``). Returns the path (``.npz``
    appended where missing)."""
    from ..convert import learned_params_to_arrays

    tree = learned_params_to_arrays(params) if isinstance(params, LearnedCNN) else params
    flat = {f"{k}.{kk}": np.asarray(v) for k, sub in tree.items() for kk, v in sub.items()}
    cfg_arr = np.asarray([cfg.nfft, cfg.hop, cfg.win_frames, cfg.win_stride, cfg.fmax_bin],
                         np.int64)
    if not path.endswith(".npz"):
        path += ".npz"
    with artifacts.atomic_file(path, "wb") as fh:
        np.savez(fh, __cfg__=cfg_arr, __features__=np.asarray(cfg.features, np.int64),
                 __compute_dtype__=np.asarray(cfg.compute_dtype), **flat)
    return path


def load_params(path: str):
    """Inverse of :func:`save_params` (of either package): returns
    ``(model, cfg)``, the model a :class:`LearnedCNN` on the CPU. Only the
    feature-geometry fields and the compute dtype round-trip (lr and
    weight decay are training concerns)."""
    from ..convert import learned_params_from_arrays

    with np.load(path) as z:
        c = z["__cfg__"]
        cdt = (str(z["__compute_dtype__"]) if "__compute_dtype__" in z.files
               else "float32")
        cfg = LearnedConfig(
            nfft=int(c[0]), hop=int(c[1]), win_frames=int(c[2]),
            win_stride=int(c[3]), fmax_bin=int(c[4]),
            features=tuple(int(f) for f in z["__features__"]),
            compute_dtype=cdt,
        )
        tree = {}
        for key in z.files:
            if key.startswith("__"):
                continue
            k, kk = key.split(".", 1)
            tree.setdefault(k, {})[kk] = np.array(z[key])
    return learned_params_from_arrays(tree, {"features": cfg.features}), cfg


def load_pretrained(name: str = "fin_cnn"):
    """``(model, cfg)`` of a model shipped with the port
    (``models/pretrained/<name>.npz``, a copy of the JAX package's file):
    detection without training. The shipped ``fin_cnn`` was trained on
    amplitude-diverse synthetic fin-call scenes."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pretrained", f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no pretrained model {name!r} (looked at {path}); train one "
            "with models.learned.fit + save_params"
        )
    return load_params(path)


@dataclass
class LearnedResult:
    picks: dict
    scores: np.ndarray        # [C, n_win] sigmoid scores
    centers: np.ndarray       # [n_win] window-center samples
    thresholds: dict = field(default_factory=dict)


class LearnedDetector:
    """Detection with a trained classifier, the other families' calling
    convention: ``detector(block)`` -> ``.picks`` ``{name: (2, n)
    [channel_idx, time_idx]}`` — the window centers of above-threshold
    windows, non-max-suppressed per channel.

    ``params`` is a :class:`LearnedCNN` or JAX's parameter pytree; the
    detector keeps its own copy on ``device`` (None: the card).
    ``row_chunk`` bounds the window rows a CNN pass takes (None: the
    whole ``[C * n_win]`` batch at once). ``syncs`` counts device->host
    reads: one a call (the scores)."""

    def __init__(self, params, cfg: LearnedConfig, threshold: float = 0.5,
                 name: str = "CALL", row_chunk: int | None = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.threshold = threshold
        self.name = name
        self.row_chunk = row_chunk
        self.model = _as_model(params, cfg).to(self.device).eval()
        self.syncs = 0

    def tiled_view(self) -> "LearnedDetector":
        """A shallow view scoring the classifier in bounded window-row
        chunks — the planner ladder's memory-lean rung for this family
        (``workflows.planner.LearnedProgram``): it caps the CNN's
        activation memory; scores are per window. Cached — repeated calls
        return the same view."""
        base = self.row_chunk or 8192

        def mutate(det):
            # never LARGER than the chunk that just ran out, and strictly
            # smaller whenever the 256-row floor allows
            det.row_chunk = min(base, max(256, base // 2))

        return cached_shallow_view(self, "_tiled_view_cache", mutate)

    def host_view(self) -> "LearnedDetector":
        """This detector on the CPU (the ladder's host rung), with its own
        copy of the model there; the STFT runs the kernel's plain version.
        Cached: repeated calls return the same view."""

        def mutate(det):
            det.device = torch.device("cpu")
            det.model = copy.deepcopy(self.model).to("cpu")

        return cached_shallow_view(self, "_host_view_cache", mutate)

    def scores(self, block, stage_hook: Callable[[str], None] | None = None,
               row_chunk: int | None = None) -> torch.Tensor:
        """``[C, T]`` block -> ``[C, n_win]`` sigmoid scores on the
        device, the CNN in passes of ``row_chunk`` window rows (None: the
        detector's own ``row_chunk``). ``stage_hook`` is called after
        ``stft``, ``features`` and ``cnn``."""
        x = _as_input(block, self.device).to(self.device)
        win, _ = window_features(x, self.cfg, device=self.device, stage_hook=stage_hook)
        del x
        C, n_win = win.shape[0], win.shape[1]
        flat = win.reshape(C * n_win, *win.shape[-2:])
        del win
        chunk, cdt = row_chunk or self.row_chunk, self.cfg.compute_dtype
        if chunk is None or flat.shape[0] <= chunk:
            s = score_windows(self.model, flat, cdt)
        else:
            s = torch.cat([score_windows(self.model, flat[i : i + chunk], cdt)
                           for i in range(0, flat.shape[0], chunk)])
        del flat
        if stage_hook is not None:
            stage_hook("cnn")
        return s.reshape(C, n_win)

    def __call__(self, block, threshold: float | None = None,
                 stage_hook: Callable[[str], None] | None = None) -> LearnedResult:
        """Detect on a strain block; ``threshold`` overrides the
        detector's for this call. ``stage_hook`` also gets
        ``finalize`` (the read and the host picks)."""
        scores = self.scores(block, stage_hook=stage_hook).cpu().numpy()
        self.syncs += 1
        res = self.picks_from_scores(scores, threshold=threshold)
        if stage_hook is not None:
            stage_hook("finalize")
        return res

    def picks_from_scores(self, scores: np.ndarray,
                          threshold: float | None = None) -> LearnedResult:
        """``[C, n_win]`` host scores -> picks (threshold + per-channel
        NMS), shared by ``__call__`` and the batched facade."""
        thr = self.threshold if threshold is None else float(threshold)
        scores = np.asarray(scores)
        centers = window_centers(scores.shape[1], self.cfg)
        above = scores > thr
        # per-channel NMS over the window axis: keep local score maxima
        left = np.pad(scores, ((0, 0), (1, 0)))[:, :-1]
        right = np.pad(scores, ((0, 0), (0, 1)))[:, 1:]
        keep = above & (scores >= left) & (scores > right)
        chan, wins = np.nonzero(keep)
        picks = np.asarray([chan, centers[wins]])
        return LearnedResult(picks={self.name: picks}, scores=scores,
                             centers=centers, thresholds={self.name: thr})
