"""Accuracy on trained weights: the reference's synthetic accuracy benchmark
on the card.

Port of ``experiments/synthetic_accuracy.py``.  The Tumblr corpus is not on
disk, so the benchmark draws a 15-class multimodal corpus whose two
modalities carry controlled, independent amounts of label information:

    y        ~ U(15)                                  true emotion
    y_img    = y with prob P_IMG else U(15)           what the image shows
    y_txt    = y with prob P_TXT else U(15)           what the caption says
    amb      ~ Bernoulli(P_AMB)                       caption is vague
    image    = class pattern(y_img) + noise  (uint8 [B, 347, 347, 3])
    tokens   = pair tokens(y_txt) if amb and y_txt<14 (one shared token set
               per class pair {2k, 2k+1}) else class tokens(y_txt); + filler

:func:`exact_ceilings` enumerates the observation space for each
modality's Bayes accuracy (image 39.3%, text ~68.3%, joint ~73.0%).  The
image cue (:func:`image_cue`) is invariant to slim's train distortions: a
mirror-symmetric cross-hatch at the angle pair {a, pi-a}, a in {9, 27, 45,
63, 81} degrees (``y_img % 5``), in one of three waveforms (``y_img //
5``): smooth, hard, checkerboard.  The reference's docstring gives the
reasons for every constant.

The corpus is drawn on the card with the port's ``torch.Generator``: it
cannot reproduce ``jax.random``'s draws, only their distribution.  Every
train batch is drawn fresh from a generator seeded by the step; the eval
batches are fixed (generator seeds ``EVAL_SEED + i``) and shared by every
run, so the rows compare paired.  Each run trains through the captured step
of ``Trainer.compile`` (``_compiled_train``, one CUDA graph per step), as
the reference trains through its jitted ``_compiled_train``, with the
reference's overrides: ``bn_momentum`` 0.99, perf mode, batch 64, adam for
the image runs, ``trainable_scopes=""`` for the end-to-end image run, and
the joint run warm-started from the trained image tower without its
``Logits`` and ``AuxLogits`` scopes.  The final int8-against-bf16 delta is
the port's int8 engine (shift epilogue, ``stem_s2d="pre"``) on the trained
end-to-end tower.

Run on the card::

    python -m tumblr_emotions_torch.synthetic_accuracy [steps_image] [steps_text]

(default 4000 and 600, the reference's); the last line is the reference's
JSON (``bayes_ceilings``, ``final``, ``paper_ordering_image<text<joint``,
``trained_tower_quantization_delta``, ``detail``).
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

P_IMG, P_TXT, P_AMB = 0.35, 0.80, 0.35
NUM_CLASSES = 15
NUM_PAIRS = NUM_CLASSES // 2        # classes {2k, 2k+1}; class 14 unpaired
B = 64
MAX_LEN = 10
TOKENS_PER_CLASS = 4
FILLER = 32
VOCAB = 2 + (NUM_CLASSES + NUM_PAIRS) * TOKENS_PER_CLASS + FILLER
HOST_SIDE = 347
EVAL_BATCHES = 20
FINAL_EVAL_BATCHES = 120            # 7,680 paired examples, sigma ~0.5%
EVAL_EVERY = 200
FREQ = 0.3                          # rad/px: a ~21 px wavelength
ANGLES_DEG = (9, 27, 45, 63, 81)
EVAL_SEED = 10_000                  # eval batch i: a generator seeded EVAL_SEED + i
TRAIN_SEED = 2                      # train batch of step s: step_seed(TRAIN_SEED, s)
INIT_SEED = 1
DELTA_SEED = 77                     # the batch of the int8-against-bf16 delta


def exact_ceilings():
    """Exact Bayes accuracy of each modality via full enumeration.

    Observation space: image evidence u in 15 labels x text evidence ev in
    {singleton 0..14} + {pair 0..6} = 22 symbols.  For each (u, ev) the
    posterior over y is computed exactly; argmax ties split their credit
    (matching what a symmetric learned classifier can achieve on average).
    """
    p_i, q_i = P_IMG + (1 - P_IMG) / 15, (1 - P_IMG) / 15
    p_t, q_t = P_TXT + (1 - P_TXT) / 15, (1 - P_TXT) / 15

    def p_u(u, y):                       # image likelihood
        return p_i if u == y else q_i

    def p_t_draw(t, y):                  # text label draw likelihood
        return p_t if t == y else q_t

    def p_ev(ev, y):                     # text EVIDENCE likelihood
        kind, idx = ev
        if kind == "s":                  # unambiguous singleton {t}
            keep = 1.0 if idx == 14 else (1 - P_AMB)
            return keep * p_t_draw(idx, y)
        a, b = 2 * idx, 2 * idx + 1      # ambiguous pair {2k, 2k+1}
        return P_AMB * (p_t_draw(a, y) + p_t_draw(b, y))

    evs = [("s", t) for t in range(15)] + [("p", k) for k in range(7)]
    img = text = joint = 0.0
    for u in range(15):
        img += (1 / 15) * p_u(u, u)      # image argmax is always u
    for ev in evs:
        lik = np.asarray([p_ev(ev, y) for y in range(15)])
        post = lik / 15
        text += post[np.isclose(lik, lik.max())].sum() / \
            np.isclose(lik, lik.max()).sum()
        for u in range(15):
            jl = lik * np.asarray([p_u(u, y) for y in range(15)])
            jp = np.asarray([(1 / 15) * p_ev(ev, y) * p_u(u, y)
                             for y in range(15)])
            top = np.isclose(jl, jl.max())
            joint += jp[top].sum() / top.sum()
    return {"image": round(img, 4), "text": round(text, 4),
            "joint": round(joint, 4)}


def draw_labels(gen: torch.Generator, n: int, device) -> Dict[str, torch.Tensor]:
    """The labels of ``n`` examples: ``y``, what the image shows
    (``y_img``), what the caption says (``y_txt``) and whether the caption
    only names ``y_txt``'s pair (``amb``), each [n]; the keep draws and the
    replacement labels are independent draws."""
    def uniform():
        return torch.rand(n, generator=gen, device=device)

    def label():
        return torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device)

    y = label()
    y_img = torch.where(uniform() < P_IMG, y, label())
    y_txt = torch.where(uniform() < P_TXT, y, label())
    amb = (uniform() < P_AMB) & (y_txt < 2 * NUM_PAIRS)
    return {"y": y, "y_img": y_img, "y_txt": y_txt, "amb": amb}


def caption_tokens(gen: torch.Generator, y_txt: torch.Tensor,
                   amb: torch.Tensor) -> torch.Tensor:
    """[n, MAX_LEN] int32 tokens: 6 from ``y_txt``'s class set (its pair's
    shared set where ``amb``), then filler; never PAD (0) or OOV (1)."""
    n, dev = y_txt.shape[0], y_txt.device
    base = torch.where(amb, (NUM_CLASSES + y_txt // 2) * TOKENS_PER_CLASS,
                       y_txt * TOKENS_PER_CLASS)
    cls_tok = 2 + base[:, None] + torch.randint(0, TOKENS_PER_CLASS, (n, 6), generator=gen,
                                                device=dev)
    fill = (2 + (NUM_CLASSES + NUM_PAIRS) * TOKENS_PER_CLASS
            + torch.randint(0, FILLER, (n, MAX_LEN - 6), generator=gen, device=dev))
    return torch.cat([cls_tok, fill], dim=1).to(torch.int32)


def image_cue(y_img: torch.Tensor, phase_u: torch.Tensor, phase_v: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """uint8 [n, side, side, 3] images of the classes ``y_img`` ([n]) with
    the phases ``phase_u``, ``phase_v`` ([n], radians) and additive
    ``noise`` ([n, side, side, 3]), in the reference's float32 arithmetic:
    the two mirror components ``u`` (angle a) and ``v`` (angle pi - a), a
    waveform of their sines, ``127 + 100 * wave + noise`` clipped to
    [0, 255] and truncated."""
    side, dev = noise.shape[1], noise.device
    grid = torch.arange(side, dtype=torch.float32, device=dev)
    yy, xx = grid[:, None].expand(side, side), grid[None, :].expand(side, side)
    angs = torch.tensor(np.asarray(ANGLES_DEG, np.float32) * np.pi / 180.0, device=dev)
    a = angs[y_img % 5][:, None, None]
    pat = (y_img // 5)[:, None, None]
    u = (xx[None] * torch.cos(a) + yy[None] * torch.sin(a)) * FREQ + phase_u[:, None, None]
    v = (-xx[None] * torch.cos(a) + yy[None] * torch.sin(a)) * FREQ + phase_v[:, None, None]
    su, sv = torch.sin(u), torch.sin(v)
    wave = torch.where(pat == 0, 0.5 * (su + sv),
                       torch.where(pat == 1, 0.5 * (torch.sign(su) + torch.sign(sv)),
                                   su * sv))
    base = 127.0 + 100.0 * wave
    return torch.clamp(base[..., None] + noise, 0, 255).to(torch.uint8)


def sample(gen: torch.Generator, n: int = B, side: int = HOST_SIDE,
           device="cuda") -> Dict[str, torch.Tensor]:
    """One batch of the corpus on ``device``, drawn from ``gen``: ``image``
    (uint8 [n, side, side, 3]), ``tokens`` (int32 [n, MAX_LEN]),
    ``lengths`` (all MAX_LEN) and ``label`` (int32, the true ``y``)."""
    lab = draw_labels(gen, n, device)
    phase_u = torch.rand(n, generator=gen, device=device) * 2 * math.pi
    phase_v = torch.rand(n, generator=gen, device=device) * 2 * math.pi
    noise = torch.rand((n, side, side, 3), generator=gen, device=device) * 50.0 - 25.0
    return {"image": image_cue(lab["y_img"], phase_u, phase_v, noise),
            "tokens": caption_tokens(gen, lab["y_txt"], lab["amb"]),
            "lengths": torch.full((n,), MAX_LEN, dtype=torch.int32, device=device),
            "label": lab["y"].to(torch.int32)}


def seeded(seed: int, device, n: int = B, side: int = HOST_SIDE) -> Dict[str, torch.Tensor]:
    """:func:`sample` from a generator seeded ``seed``."""
    return sample(torch.Generator(device=device).manual_seed(seed), n, side, device)


def _initial_state(cfg, seed: int) -> Dict[str, torch.Tensor]:
    from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model

    init = {"image": inception_v3.init_state, "joint": joint_model.init_state,
            "text": text_model.init_state}[cfg.model]
    return init(build_model(cfg, device="meta"), seed)


def tower_pretrained(image_state: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """A trained image model's state as ``checkpoint.merge_pretrained``'s
    input, with slim's warm-start filter: every leaf but the ``Logits`` and
    ``AuxLogits`` scopes."""
    from tumblr_emotions_torch.train.trainer import path_in_scopes
    from tumblr_emotions_torch.utils.checkpoint import is_stat

    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for k, v in image_state.items():
        if path_in_scopes(k, ("Logits", "AuxLogits")):
            continue
        out["batch_stats" if is_stat(k) else "params"][k.replace(".", "/")] = v.detach()
    return out


def run_preset(name: str, steps: int, device, extra: Optional[dict] = None,
               tag: Optional[str] = None, bn_momentum: float = 0.99,
               warm_tower: Optional[Dict[str, torch.Tensor]] = None,
               side: int = HOST_SIDE, log=print,
               losses: Optional[list] = None) -> Tuple[dict, object]:
    """Train ``name``'s preset for ``steps`` on the corpus; returns the
    curve and the final wide eval (the reference's dict) and the trained
    TrainState.  ``extra`` overrides ``TrainConfig`` fields;
    ``warm_tower`` (a trained image model's state) is grafted into the
    joint model's tower with slim's exclude-Logits/AuxLogits filter;
    ``losses`` (a list) gets every step's loss, on the device.  The
    reference's ``run_preset`` docstring explains the two short-horizon
    overrides (``bn_momentum`` 0.99; adam where ``extra`` says so)."""
    from tumblr_emotions_torch.config import get_preset
    from tumblr_emotions_torch.train.trainer import Trainer, step_seed
    from tumblr_emotions_torch.utils.checkpoint import merge_pretrained

    cfg = get_preset(name)
    cfg = cfg.replace(
        image=cfg.image.replace(bn_momentum=bn_momentum),
        text=cfg.text.replace(vocab_size=VOCAB, max_len=MAX_LEN, embed_dim=64),
        train=cfg.train.replace(batch_size=B, precision_mode="perf", num_steps=steps,
                                **dict(extra or {})))
    tag = tag or name
    trainer = Trainer(cfg, preprocess="train" if cfg.model != "text" else None,
                      device=device).compile()
    state = _initial_state(cfg, INIT_SEED)
    if warm_tower is not None:
        state = merge_pretrained(state, tower_pretrained(warm_tower), subtree="InceptionV3")
    ts = trainer.init_state(state)
    dev = trainer.device

    def batch_of(seed: int) -> Dict[str, torch.Tensor]:
        b = seeded(seed, dev, B, side)
        return {k: v for k, v in b.items() if k != "image"} if cfg.model == "text" else b

    def evaluate(st, n_batches: int = EVAL_BATCHES) -> float:
        # Fixed eval batches shared by every model: paired comparisons.
        correct = count = 0
        for i in range(n_batches):
            stats = trainer._compiled_eval(st, batch_of(EVAL_SEED + i))
            correct += int(stats["correct"])
            count += int(stats["count"])
        return correct / max(count, 1)

    curve = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for step in range(steps):
        batch = batch_of(step_seed(TRAIN_SEED, step))
        trainer.generator.manual_seed(step_seed(cfg.train.seed, step))
        ts, m = trainer._compiled_train(ts, batch, trainer.generator)
        if losses is not None:
            losses.append(m["loss"])
        if (step + 1) % EVAL_EVERY == 0 or step + 1 == steps:
            acc = evaluate(ts)
            curve.append({"step": step + 1, "eval_acc": round(acc, 4),
                          "train_loss": round(float(m["loss"]), 4),
                          "train_acc": round(float(m["accuracy"]), 4)})
            log(json.dumps({"model": tag, **curve[-1]}))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    # The headline number: one wide paired eval (7,680 examples, binomial
    # sigma ~0.5%); the curve's 20-batch evals have ~1.2%.
    wide = evaluate(ts, n_batches=FINAL_EVAL_BATCHES)
    return ({"preset": name, "tag": tag, "steps": steps, "final_eval_acc": round(wide, 4),
             "final_eval_examples": FINAL_EVAL_BATCHES * B, "curve": curve,
             "img_s": round(B * steps / dt, 1), "step_mode": trainer.step_mode}, ts)


def main(argv=None, device="cuda", side: int = HOST_SIDE, log=print) -> dict:
    """The reference's four runs and its final line (printed and returned):
    text, the image linear probe over the random frozen tower (at most
    1,500 steps), the image tower trained end to end, and the joint model
    warm-started from that tower."""
    from tumblr_emotions_torch._device import resolve_device
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.ops.quant import quantization_delta

    dev = resolve_device(device)
    argv = sys.argv[1:] if argv is None else list(argv)
    steps_img = int(argv[0]) if len(argv) > 0 else 4000
    steps_txt = int(argv[1]) if len(argv) > 1 else 600
    results = {}
    results["text"], _ = run_preset("text_only", steps_txt, dev, side=side, log=log)
    # The preset verbatim: a linear probe over the random frozen tower.
    results["image_probe"], _ = run_preset(
        "image_frozen", min(steps_img, 1500), dev,
        extra={"optimizer": "adam", "learning_rate": 1e-3}, tag="image_frozen_probe",
        side=side, log=log)
    # The paper's image row is a fine-tuned Inception: the ordering uses it.
    results["image"], image_ts = run_preset(
        "image_frozen", steps_img, dev,
        extra={"optimizer": "adam", "learning_rate": 3e-4, "trainable_scopes": ""},
        tag="image_e2e", side=side, log=log)
    tower = {k: v.detach() for k, v in image_ts.state.items()}
    del image_ts
    results["joint"], _ = run_preset(
        "joint_finetune", steps_img, dev,
        extra={"optimizer": "adam", "learning_rate": 3e-4, "lr_decay_steps": 1500,
               "lr_decay_factor": 0.5},
        warm_tower=tower, side=side, log=log)
    ordering = (results["image"]["final_eval_acc"] < results["text"]["final_eval_acc"]
                < results["joint"]["final_eval_acc"])
    # The int8 engine against bf16 on the trained image tower (its Logits
    # head is trained), over one seeded batch.
    images = preprocess_for_eval(seeded(DELTA_SEED, dev, B, side)["image"],
                                 dtype=torch.float32)
    delta = quantization_delta(tower, images, device=dev, epilogue="shift", stem_s2d="pre")
    out = {"bayes_ceilings": exact_ceilings(),
           "final": {r["tag"]: r["final_eval_acc"] for r in results.values()},
           "paper_ordering_image<text<joint": bool(ordering),
           "trained_tower_quantization_delta": delta,
           "detail": list(results.values())}
    log(json.dumps(out))
    return out


if __name__ == "__main__":
    main(log=lambda line: print(line, flush=True))
