"""Command-line entry points of the port: train / eval / predict / analyze /
infer / serve / parity / tune plus the dataset tooling (convert-dataset,
build-vocab, export-checkpoint, train-embeddings, scrape).

Port of ``tumblr_emotions_tpu/cli.py`` over the port's modules, with the
reference's commands, flags and output:

  python -m tumblr_emotions_torch.cli convert-dataset --csv posts.csv \\
      --images-dir images/ --out data/
  python -m tumblr_emotions_torch.cli train --preset joint_finetune \\
      --records 'data/train-*.tfrecord' --vocab data/vocab.txt \\
      --checkpoint-dir ckpt/ [--warmstart inception_v3.ckpt]
  python -m tumblr_emotions_torch.cli eval --preset joint_finetune \\
      --records 'data/validation-*.tfrecord' --vocab data/vocab.txt \\
      --checkpoint-dir ckpt/ [--follow]
  python -m tumblr_emotions_torch.cli infer|serve|predict|analyze ...
  python -m tumblr_emotions_torch.cli export-checkpoint --out slim/model.ckpt ...
  python -m tumblr_emotions_torch.cli parity --warmstart slim/model.ckpt \\
      --goldens goldens.npz
  python -m tumblr_emotions_torch.cli tune --engine int8 --batch-size 64
  python -m tumblr_emotions_torch.cli train-embeddings --csv posts.csv \\
      --vocab data/vocab.txt --out w2v.npy
  python -m tumblr_emotions_torch.cli scrape --consumer-key KEY --out scraped/

Every command that runs a model takes ``--device`` (default ``cuda``, which
raises without a card; ``--device cpu`` runs on the CPU).  ``train``
resumes from the latest checkpoint in ``--checkpoint-dir`` at the exact
input record.  ``train`` and ``eval`` run as several processes, one card
each (data parallel, ``parallel/``): started with ``--coordinator-address
host:port --num-processes N --process-id i`` each, or by torchrun (its
environment); each process reads its shard of the records.  Every served
program runs as one captured CUDA graph per batch shape, and so do
``train``'s and ``eval``'s steps (``utils/compile_opts.py``;
``TET_TORCH_COMPILER_OPTIONS`` and ``TET_TORCH_TRAIN_COMPILER_OPTIONS``
override the options, ``tune`` and ``tune --step train`` measure them).
``infer --dp`` and ``serve --dp`` split each batch of the int8 and bf16
engines over every visible card (``ops/serving.data_parallel_server``);
``infer`` and ``serve`` run one process, and take the process-group flags
without acting on them, as the reference's do.  ``--records`` takes
TFRecord or ArrayRecord (``.arrayrecord``) shards.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import sys
import time
from typing import Dict

import numpy as np

log = logging.getLogger("tumblr_emotions_torch")

def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="joint_finetune")
    p.add_argument("--model", choices=["text", "image", "joint"], default=None)
    p.add_argument("--records", default="", help="TFRecord or .arrayrecord glob")
    p.add_argument("--csv", default="", help="posts CSV (text-only runs)")
    p.add_argument("--vocab", default="", help="vocab.txt path")
    p.add_argument("--embeddings", default="", help="GloVe txt / .npy matrix")
    p.add_argument("--labels", default="", help="labels.txt (defaults to built-in)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--learning-rate", type=float, default=0.0)
    p.add_argument("--max-len", type=int, default=0)
    p.add_argument("--image-size", type=int, default=0)
    p.add_argument("--depth-multiplier", type=float, default=0.0)
    p.add_argument("--no-aux", action="store_true",
                   help="disable the auxiliary classifier head")
    p.add_argument("--precision", choices=["parity", "perf"], default="")
    p.add_argument("--warmstart", default="",
                   help="slim .ckpt to warm-start the Inception tower from")
    p.add_argument("--trainable-scopes", default=None,
                   help="comma list; e.g. Logits,AuxLogits for head-only")
    p.add_argument("--head-steps", type=int, default=0,
                   help="two-phase fine-tune: first N steps train only the new heads "
                        "(Logits/AuxLogits/JointLogits/TextLogits), then the remaining "
                        "steps train end-to-end (the reference's warm-start recipe)")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint (and in-train eval) interval in steps")
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--coordinator-address", default="")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda: the card; cpu for a machine "
                        "without one)")


def _build_config(args):
    from tumblr_emotions_torch.config import get_preset

    cfg = get_preset(args.preset)
    if args.model:
        cfg = cfg.replace(model=args.model)
    t = {}
    if args.batch_size:
        t["batch_size"] = args.batch_size
    if args.steps:
        t["num_steps"] = args.steps
    if args.learning_rate:
        t["learning_rate"] = args.learning_rate
    if args.checkpoint_dir:
        t["checkpoint_dir"] = args.checkpoint_dir
    if args.precision:
        t["precision_mode"] = args.precision
    if args.warmstart:
        t["warmstart_checkpoint"] = args.warmstart
    if args.trainable_scopes is not None:
        t["trainable_scopes"] = args.trainable_scopes
    if args.seed >= 0:
        t["seed"] = args.seed
    if getattr(args, "checkpoint_every", 0):
        t["checkpoint_every"] = args.checkpoint_every
    if getattr(args, "log_every", 0):
        t["log_every"] = args.log_every
    if t:
        cfg = cfg.replace(train=cfg.train.replace(**t))
    if args.max_len:
        cfg = cfg.replace(text=cfg.text.replace(max_len=args.max_len))
    im = {}
    if args.image_size:
        im["image_size"] = args.image_size
    if args.depth_multiplier:
        im["depth_multiplier"] = args.depth_multiplier
        im["min_depth"] = 8
    if args.no_aux:
        im["create_aux_logits"] = False
    if im:
        cfg = cfg.replace(image=cfg.image.replace(**im))
    if getattr(args, "labels", ""):
        # A custom label file resizes every classifier head.
        cfg = cfg.replace(image=cfg.image.replace(num_classes=len(_load_emotions(args))))
    return cfg


def _load_emotions(args):
    from tumblr_emotions_torch.config import EMOTIONS

    if args.labels:
        with open(args.labels) as f:
            return tuple(line.strip() for line in f if line.strip())
    return EMOTIONS


def _load_vocab(args, cfg, texts=None):
    from tumblr_emotions_torch.data.vocab import Vocabulary, build_vocabulary

    if args.vocab:
        return Vocabulary.load(args.vocab)
    if texts is not None:
        return build_vocabulary(texts, max_size=cfg.text.vocab_size)
    raise SystemExit("--vocab is required for records input")


def _maybe_init_distributed(args) -> None:
    """Join the run's process group (an explicit coordinator, else
    torchrun's environment; parallel/distributed.py) and take this
    process's card."""
    from tumblr_emotions_torch.parallel import distributed

    if distributed.maybe_initialize(
            coordinator_address=args.coordinator_address or None,
            num_processes=args.num_processes or None,
            process_id=args.process_id if args.process_id >= 0 else None,
            device=args.device):
        rank, world = distributed.host_shard_options()
        args.device = str(distributed.process_device(
            args.device, rank, distributed.local_world_size(world)))


def _serving_devices(args, dev, engine: str, model: str) -> list:
    """The devices ``infer`` and ``serve`` split each batch over: with
    ``--dp``, every visible card (the one CPU for ``--device cpu``), else
    ``dev``; the parity engine and a text model stay on ``dev``."""
    import torch

    if not args.dp or engine == "parity" or model == "text" or dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _make_batches(args, cfg, vocab, train: bool, shard_eval: bool = False):
    from tumblr_emotions_torch.data import csv_dataset, pipeline
    from tumblr_emotions_torch.parallel import distributed

    bs = cfg.train.batch_size if train else cfg.train.eval_batch_size
    if args.csv and cfg.model != "text":
        raise SystemExit(
            f"--csv provides text-only batches; model {cfg.model!r} needs "
            "images: convert the dataset and pass --records instead")
    if args.csv:
        posts = csv_dataset.load_posts_csv(args.csv, emotions=_load_emotions(args))
        return csv_dataset.text_batches(
            posts, vocab, bs, cfg.text.max_len, shuffle=train,
            seed=cfg.train.seed, num_epochs=None if train else 1,
            drop_remainder=train)
    if not args.records:
        raise SystemExit("need --records or --csv")
    # Each process of a data-parallel run reads its slice of the records:
    # always in training, in evaluation when the statistics are reduced
    # over the processes (Trainer.evaluate in lockstep); infer and serve
    # read everything.
    shard_index, shard_count = (distributed.host_shard_options()
                                if (train or shard_eval) else (0, 1))
    pcfg = pipeline.PipelineConfig(
        batch_size=bs, max_len=cfg.text.max_len, shuffle=train,
        seed=cfg.train.seed, num_epochs=None if train else 1,
        drop_remainder=train, decode_threads=cfg.data.num_workers,
        shard_index=shard_index, shard_count=shard_count)
    return pipeline.batches(args.records, vocab, pcfg)


def _initial_state(cfg) -> Dict:
    """Seeded initial weights of ``cfg``'s model (``cfg.train.seed``)."""
    from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model

    init = {"image": inception_v3.init_state, "joint": joint_model.init_state,
            "text": text_model.init_state}[cfg.model]
    return init(build_model(cfg, device="meta"), cfg.train.seed)


def _init_trainer_state(args, cfg, vocab, sample_batch):
    from tumblr_emotions_torch.data.vocab import load_embeddings
    from tumblr_emotions_torch.train.trainer import Trainer
    from tumblr_emotions_torch.utils import checkpoint as ckpt_lib

    if vocab is not None:
        cfg = cfg.replace(text=cfg.text.replace(vocab_size=vocab.size))
    preprocess = None
    if cfg.model in ("image", "joint") and "image" in sample_batch and \
            np.asarray(sample_batch["image"]).dtype == np.uint8:
        preprocess = "train"
    emb = None
    if args.embeddings and vocab is not None:
        if args.embeddings.endswith(".npy"):
            emb = np.load(args.embeddings).astype(np.float32)
            if emb.shape[0] != vocab.size:
                raise SystemExit(f"embedding rows {emb.shape[0]} != vocab size {vocab.size}")
            cfg = cfg.replace(text=cfg.text.replace(embed_dim=emb.shape[1]))
        else:
            emb = load_embeddings(args.embeddings, vocab, cfg.text.embed_dim)
    trainer = Trainer(cfg, preprocess=preprocess, device=args.device)
    state = _initial_state(cfg)
    if cfg.train.warmstart_checkpoint:
        pretrained = ckpt_lib.load_slim_checkpoint(
            cfg.train.warmstart_checkpoint, exclude_scopes=cfg.train.warmstart_exclude)
        state = ckpt_lib.merge_pretrained(
            state, pretrained, subtree="InceptionV3" if cfg.model == "joint" else None)
        log.info("warm-started from %s", cfg.train.warmstart_checkpoint)
    return trainer, trainer.init_state(state, embedding_matrix=emb), cfg


def _restored(trainer, ts, what: str):
    restored = trainer.restore_latest(ts)
    if restored is None:
        log.warning("no checkpoint found in %s; %s from fresh init",
                    trainer.cfg.train.checkpoint_dir, what)
        return ts
    return restored


def _weights(ts) -> Dict:
    """A TrainState's state dict, detached, for the served programs."""
    return {k: v.detach() for k, v in ts.state.items()}


def cmd_train(args) -> int:
    from tumblr_emotions_torch.data import pipeline
    from tumblr_emotions_torch.train.trainer import Trainer, TrainState

    _maybe_init_distributed(args)
    cfg = _build_config(args)
    vocab = None
    if cfg.model in ("text", "joint"):
        texts = None
        if args.csv and not args.vocab:
            from tumblr_emotions_torch.data.csv_dataset import load_posts_csv

            texts = [p.text for p in load_posts_csv(args.csv)]
        vocab = _load_vocab(args, cfg, texts)
    batches = _make_batches(args, cfg, vocab, train=True)
    it = iter(batches)
    first = next(it)
    trainer, state, cfg = _init_trainer_state(args, cfg, vocab, first)
    trainer.checkpoint_manager()
    resumed = trainer.restore_latest(state)
    resumed_input = False
    if resumed is not None:
        state = resumed
        # Resume the input position too (saved with each checkpoint), so the
        # stream does not replay the epoch's seen prefix; `first` (pulled
        # for shape inference) is superseded by set_state.
        resumed_input = trainer.restore_input_iterator(it)
        log.info("resumed at step %d%s", state.step,
                 " (input position restored)" if resumed_input else "")
    stream = it if resumed_input else itertools.chain([first], it)
    eval_batches = None
    if args.eval_records or args.eval_csv:
        eval_args = argparse.Namespace(**vars(args))
        eval_args.records, eval_args.csv = args.eval_records, args.eval_csv
        eval_batches = lambda: _make_batches(eval_args, cfg, vocab, train=False)  # noqa: E731
    input_it = it if hasattr(it, "get_state") else None
    if args.prefetch_depth > 0:
        # A producer thread keeps batches on the device; it reports the
        # consumed position, so exact-record resume holds.
        stream = pipeline.DevicePrefetchIterator(stream, trainer.device,
                                                 depth=args.prefetch_depth,
                                                 state_source=input_it)
        if input_it is not None:
            input_it = stream
    if args.head_steps and state.step < args.head_steps:
        # Phase 1: only the classification heads train.
        heads = "Logits,AuxLogits,JointLogits,JointHidden,TextLogits,TextHidden"
        head_cfg = cfg.replace(train=cfg.train.replace(trainable_scopes=heads))
        head_trainer = Trainer(head_cfg, preprocess=trainer.preprocess, device=trainer.device)
        head = head_trainer.init_state(state.state)
        head_state = TrainState(state.step, head.state, head.opt_state)
        log.info("phase 1: training heads only for %d steps", args.head_steps)
        head_state = head_trainer.fit(head_state, stream,
                                      num_steps=args.head_steps - state.step,
                                      eval_batches=eval_batches, input_iterator=input_it)
        # Phase 2 resumes with a fresh full-model optimizer.
        full = trainer.init_state(head_state.state)
        state = TrainState(head_state.step, full.state, full.opt_state)
        log.info("phase 2: fine-tuning end-to-end")
    state = trainer.fit(state, stream, num_steps=cfg.train.num_steps - state.step,
                        eval_batches=eval_batches, input_iterator=input_it)
    log.info("finished at step %d", state.step)
    return 0


def cmd_eval(args) -> int:
    from tumblr_emotions_torch.parallel import distributed
    from tumblr_emotions_torch.utils.metrics import format_per_class

    _maybe_init_distributed(args)
    cfg = _build_config(args)
    emotions = _load_emotions(args)
    vocab = _load_vocab(args, cfg) if cfg.model in ("text", "joint") else None
    batches = list(_make_batches(args, cfg, vocab, train=False, shard_eval=True))
    # (a process whose shard is empty fails in the lockstep eval, with the
    # reference's message)
    sample = batches[0] if batches else _sample(cfg, cfg.image.image_size, np.uint8)
    trainer, state, cfg = _init_trainer_state(args, cfg, vocab, sample)
    # Eval batches may arrive as uint8 host images: use eval preprocessing.
    if trainer.preprocess is not None:
        trainer.preprocess = "eval"
    first = distributed.host_shard_options()[0] == 0   # one report for the group
    if args.follow:
        # slim evaluation_loop mode: every new checkpoint until the run's
        # final step.
        for step, summary in trainer.evaluate_continuously(
                state, lambda: batches, class_names=emotions,
                interval_secs=args.eval_interval, timeout_secs=args.eval_timeout or None):
            if first:
                print(f"== step {step} ==")
                print(format_per_class(summary))
                _write_summary(args.out, dict(summary, step=step))
        return 0
    state = _restored(trainer, state, "evaluating")
    summary = trainer.evaluate(state, batches, class_names=emotions)
    if first:
        print(format_per_class(summary))
        _write_summary(args.out, dict(summary, step=state.step))
    return 0


def _write_summary(path: str, summary: Dict) -> None:
    """The evaluation summary as one JSON line (appended) at ``path``."""
    if not path:
        return
    with open(path, "a") as f:
        f.write(json.dumps({k: np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
                            for k, v in summary.items()}) + "\n")


def _sample(cfg, image_size: int, image_dtype=np.float32) -> Dict[str, np.ndarray]:
    sample: Dict[str, np.ndarray] = {"label": np.zeros((1,), np.int32)}
    if cfg.model in ("image", "joint"):
        sample["image"] = np.zeros((1, image_size, image_size, 3), image_dtype)
    if cfg.model in ("text", "joint"):
        sample["tokens"] = np.zeros((1, cfg.text.max_len), np.int32)
        sample["lengths"] = np.ones((1,), np.int32)
    return sample


def cmd_predict(args) -> int:
    from tumblr_emotions_torch.train.predict import Predictor

    cfg = _build_config(args)
    emotions = _load_emotions(args)
    vocab = _load_vocab(args, cfg) if cfg.model in ("text", "joint") else None
    trainer, state, cfg = _init_trainer_state(args, cfg, vocab, _sample(cfg, 299))
    restored = trainer.restore_latest(state)
    if restored is not None:
        state = restored
    elif not cfg.train.warmstart_checkpoint:
        log.warning("no checkpoint found in %s; predicting from fresh init",
                    cfg.train.checkpoint_dir)
    predictor = Predictor(cfg, _weights(state), vocab=vocab, emotions=emotions,
                          device=trainer.device)
    image_bytes = open(args.image, "rb").read() if args.image else None
    result = predictor.predict(image_bytes=image_bytes, text=args.text or None)
    print(json.dumps(result, indent=2))
    return 0


def cmd_analyze(args) -> int:
    """Emotion-circumplex analysis (the paper's notebook analysis): collect
    the trained model's probabilities over a split with the trainer's eval
    forward on the device, PCA the per-emotion means, print coordinates and
    angular order; with --examples, the qualitative report."""
    from tumblr_emotions_torch import analysis

    cfg = _build_config(args)
    emotions = _load_emotions(args)
    vocab = _load_vocab(args, cfg) if cfg.model in ("text", "joint") else None
    batches = list(_make_batches(args, cfg, vocab, train=False))
    trainer, state, cfg = _init_trainer_state(args, cfg, vocab, batches[0])
    restored = trainer.restore_latest(state)
    if restored is not None:
        state = restored
    if trainer.preprocess is not None:
        trainer.preprocess = "eval"
    all_probs, all_labels = [], []
    for b in batches:
        p = trainer.predict_step(state, b).float().cpu().numpy()
        w = np.asarray(b.get("weight", np.ones(len(p), np.int32))) == 1
        all_probs.append(p[w])
        all_labels.append(np.asarray(b["label"])[w])
    probs = np.concatenate(all_probs)
    labels = np.concatenate(all_labels)
    result = analysis.circumplex(probs, labels, emotions=emotions)
    print(analysis.format_circumplex(result))
    if args.plot:
        print(f"wrote {analysis.plot_circumplex(result, args.plot)}")
    if args.examples:
        # The split is read unshuffled (train=False), so row i of the
        # collected probabilities is record / post i of the split.
        ex = analysis.qualitative_examples(probs, labels, emotions=emotions, k=args.top_k)
        lookup = _post_lookup(args, ex)
        print()
        print(analysis.format_examples(ex, lookup=lookup))
        print(f"wrote {analysis.write_examples_report(ex, args.examples, lookup=lookup)}")
    return 0


def _post_lookup(args, result):
    """index -> "[id] text-snippet" for the qualitative report, reading only
    the records it names (random access through the offset index)."""
    needed = set()
    for block in result["per_emotion"].values():
        needed.update(e["index"] for e in block["correct"])
        needed.update(e["index"] for e in block["misclassified"])
    for c in result["confusions"]:
        needed.update(c["examples"])
    cache: Dict[int, str] = {}
    if args.records:
        from tumblr_emotions_torch.data import pipeline, records

        idx = pipeline.record_source(args.records)
        for i in needed:
            if 0 <= i < len(idx):
                post = records.example_to_post(idx[i])
                text = " ".join(str(post.get("text", "")).split())[:80]
                cache[i] = f"[{post.get('id', i)}] {text}"
    elif args.csv:
        from tumblr_emotions_torch.data.csv_dataset import load_posts_csv

        posts = load_posts_csv(args.csv, emotions=_load_emotions(args))
        for i in needed:
            if 0 <= i < len(posts):
                text = " ".join(posts[i].text.split())[:80]
                cache[i] = f"[{posts[i].post_id or i}] {text}"
    return lambda i: cache.get(i, f"#{i}")


def _calibration(cfg, images, device):
    """The int8 engine's calibration batch: the first 64 images with the
    eval preprocessing the engine serves with."""
    import torch

    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval

    s = cfg.image.image_size
    return preprocess_for_eval(torch.as_tensor(np.asarray(images[:64])).to(device), s, s,
                               central_fraction=cfg.data.eval_central_crop,
                               resize_method=cfg.data.resize_method, dtype=torch.float32)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_infer(args) -> int:
    """Batch inference over a records split with the served engines: int8
    (quantized, the default), bf16 (BN-folded) or parity (the f32 slim
    model).  Serves the image model, or the joint model (the tower in the
    engine, the text branch and fusion head on its feature; needs
    --vocab).  Writes one JSON line per example to --out (and, with
    --probs-out, the probabilities unrounded as a .npy), and prints a
    summary with the measured images/s."""
    import torch

    from tumblr_emotions_torch.models.joint_model import tower_state
    from tumblr_emotions_torch.ops import serving as serving_lib

    cfg = _build_config(args)
    if cfg.model == "text":
        raise SystemExit("infer serves the image/joint towers; use eval/predict for "
                         "text-only models")
    emotions = _load_emotions(args)
    vocab = _load_vocab(args, cfg) if cfg.model == "joint" else None
    batches = list(_make_batches(args, cfg, vocab, train=False))
    trainer, state, cfg = _init_trainer_state(args, cfg, vocab, batches[0])
    dev = trainer.device
    weights = _weights(_restored(trainer, state, "serving"))
    tower = weights if cfg.model == "image" else tower_state(weights)
    calib = _calibration(cfg, batches[0]["image"], dev) if args.engine == "int8" else None
    devices = _serving_devices(args, dev, args.engine, cfg.model)
    runner = serving_lib.build_forward(cfg, weights, engine=args.engine, devices=devices,
                                       calib_images=calib, front=args.front)

    def forward(b):
        tokens = lengths = None
        if cfg.model == "joint":
            tokens = torch.as_tensor(b["tokens"]).to(dev)
            lengths = torch.as_tensor(b["lengths"]).to(dev) if "lengths" in b else None
        return runner(b["image"], tokens, lengths).float().cpu().numpy()

    forward(batches[0])  # untimed warm-up: steady-state images/s
    n, n_correct, t_total, n_timed = 0, 0, 0.0, 0
    kept = []
    out_f = open(args.out, "w") if args.out else None
    for b in batches:
        _sync(dev)
        t0 = time.perf_counter()
        probs = forward(b)
        t_total += time.perf_counter() - t0
        valid = np.asarray(b.get("weight", np.ones(len(probs), np.int32))) == 1
        n_timed += int(valid.sum())  # real images: padding rows are not served
        kept.append(probs[valid])
        for i in np.nonzero(valid)[0]:
            n += 1
            n_correct += int(probs[i].argmax() == int(b["label"][i]))
            if out_f is not None:
                out_f.write(json.dumps({
                    "label": int(b["label"][i]),
                    "top1": emotions[int(probs[i].argmax())],
                    "probs": {e: round(float(p), 5) for e, p in zip(emotions, probs[i])},
                }) + "\n")
    if out_f is not None:
        out_f.close()
    if args.probs_out:
        np.save(args.probs_out, np.concatenate(kept))
    summary = {"examples": n, "engine": args.engine,
               "accuracy": round(n_correct / max(n, 1), 4),
               "images_per_sec": round(n_timed / max(t_total, 1e-9), 1),
               "forwards": len(batches) + 1, "devices": len(devices)}
    if args.validate and args.engine == "int8":
        from tumblr_emotions_torch.ops.quant import quantization_delta

        imgs = _calibration(cfg, batches[0]["image"], dev)
        summary["quantization_delta"] = quantization_delta(
            tower, imgs, device=dev, stem_s2d="pre" if args.front == "s2d" else False)
    print(json.dumps(summary))
    return 0


def build_server(args):
    """The serving stack of ``cmd_serve`` for the ``serve`` command's
    arguments (``parser().parse_args(["serve", ...])``): (EmotionHTTPServer,
    info), the server bound but not yet serving, the runner warmed up.
    ``info`` is the JSON line ``cmd_serve`` prints, with the runner under
    ``runner``."""
    from tumblr_emotions_torch.ops import serving as serving_lib
    from tumblr_emotions_torch.server import BatchedPredictor, EmotionHTTPServer

    cfg = _build_config(args)
    emotions = _load_emotions(args)
    if args.engine == "int8" and cfg.model != "text" and not args.records:
        raise SystemExit("--engine int8 needs --records for a real calibration batch "
                         "(or use bf16/parity)")
    vocab = _load_vocab(args, cfg) if cfg.model in ("text", "joint") else None
    B, S = args.serve_batch_size, args.host_size
    trainer, state, cfg = _init_trainer_state(args, cfg, vocab, _sample(cfg, S, np.uint8))
    dev = trainer.device
    weights = _weights(_restored(trainer, state, "serving"))
    engine = "parity" if cfg.model == "text" else args.engine
    devices = _serving_devices(args, dev, engine, cfg.model)
    if B % len(devices):
        raise SystemExit(f"--serve-batch-size {B} does not split over {len(devices)} "
                         f"devices: use a multiple of {len(devices)}")
    calib = None
    if engine == "int8":
        first = next(iter(_make_batches(args, cfg, vocab, train=False)))
        calib = _calibration(cfg, first["image"], dev)
    runner = serving_lib.build_forward(cfg, weights, engine=engine, devices=devices,
                                       calib_images=calib, front=args.front)
    predictor = BatchedPredictor(
        runner, B, host_size=S, needs_image=cfg.model in ("image", "joint"),
        vocab=vocab, max_len=cfg.text.max_len, max_delay_ms=args.max_delay_ms,
        max_queue=args.max_queue or None, decode_threads=cfg.data.num_workers,
        emotions=emotions)
    # Pay the first call's set-up before accepting traffic.
    warm_img = np.zeros((B, S, S, 3), np.uint8) if cfg.model in ("image", "joint") else None
    warm_tok = np.zeros((B, cfg.text.max_len), np.int32) if vocab is not None else None
    warm_len = np.ones((B,), np.int32) if vocab is not None else None
    runner(warm_img, warm_tok, warm_len).cpu()
    httpd = EmotionHTTPServer(predictor, host=args.host, port=args.port,
                              request_timeout=args.request_timeout)
    info = {"serving": True, "host": httpd.server_address[0],
            "port": httpd.server_address[1], "engine": engine, "model": cfg.model,
            "batch_size": B, "max_delay_ms": args.max_delay_ms, "device": str(dev),
            "devices": len(devices)}
    return httpd, dict(info, runner=runner)


def cmd_serve(args) -> int:
    """Online HTTP serving with micro-batching (server.py) of the latest
    checkpoint.  --port 0 binds an ephemeral port (printed on stdout as JSON)."""
    httpd, info = build_server(args)
    info.pop("runner")
    print(json.dumps(info), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.close()
    return 0


def cmd_parity(args) -> int:
    """One-shot parity gate: the f32 slim tower (TF32 off) on ``--warmstart``
    against golden logits within ``--tolerance`` (the 1e-4 contract).

    ``--goldens`` is an .npz with ``raw`` (uint8 [N,H,W,3], run through the
    eval preprocessing) or ``images`` (float32 [N,S,S,3], preprocessed),
    plus ``logits`` (float32 [N,num_classes]); the reference's format, so
    either package's goldens check the other.  With ``--save-goldens`` the
    command writes such a file from this forward instead.  num_classes and
    the aux head are read from the checkpoint.  Prints one JSON line; exits
    0 on a pass, 1 otherwise."""
    import torch

    from tumblr_emotions_torch._device import full_f32, resolve_device
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
    from tumblr_emotions_torch.utils import checkpoint as ckpt_lib

    if not args.warmstart:
        raise SystemExit("parity needs --warmstart <slim.ckpt>")
    pretrained = ckpt_lib.load_slim_checkpoint(args.warmstart, exclude_scopes=())
    logits_w = pretrained["params"].get("Logits/Conv2d_1c_1x1/weights")
    if logits_w is None:
        raise SystemExit("checkpoint has no Logits/Conv2d_1c_1x1 -- cannot run the "
                         "logit-parity gate against it")
    num_classes = int(logits_w.shape[0])          # OIHW
    has_aux = any(k.startswith("AuxLogits/") for k in pretrained["params"])
    if args.save_goldens:
        if not args.images:
            raise SystemExit("--save-goldens needs --images <npz>")
        data = np.load(args.images)
    elif args.goldens:
        data = np.load(args.goldens)
    else:
        raise SystemExit("need --goldens (check) or --images + --save-goldens (generate)")
    dev = resolve_device(args.device)
    if "images" in data:
        images = torch.from_numpy(np.asarray(data["images"], np.float32)).to(dev)
    elif "raw" in data:
        images = preprocess_for_eval(torch.from_numpy(np.asarray(data["raw"])).to(dev),
                                     dtype=torch.float32)
    else:
        raise SystemExit("npz must contain 'images' (preprocessed f32) or 'raw' (uint8)")

    model = InceptionV3(num_classes=num_classes, create_aux_logits=has_aux,
                        depth_multiplier=args.depth_multiplier, min_depth=args.min_depth,
                        image_size=images.shape[1], device=dev)
    state = ckpt_lib.merge_pretrained(init_state(model, 0), pretrained)
    model.load_state_dict(state)
    with torch.inference_mode(), full_f32():
        logits = model(images)[0].float().cpu().numpy()

    if args.save_goldens:
        key = "images" if "images" in data else "raw"
        np.savez(args.save_goldens, logits=logits, **{key: np.asarray(data[key])})
        print(f"wrote goldens for {len(logits)} examples to {args.save_goldens}")
        return 0
    want = np.asarray(data["logits"], np.float32)
    if want.shape != logits.shape:
        raise SystemExit(f"golden logits {want.shape} != model {logits.shape}")
    max_abs = float(np.max(np.abs(want - logits)))
    ok = max_abs <= args.tolerance
    print(json.dumps({"max_abs_diff": max_abs, "tolerance": args.tolerance,
                      "num_examples": int(len(logits)), "num_classes": num_classes,
                      "pass": ok}))
    return 0 if ok else 1


def cmd_tune(args) -> int:
    """Time the served program's options (``utils/compile_opts.autotune``:
    the eager program against one CUDA graph per batch) and keep the winner
    in a JSON cache.  The program is the one ``build_forward`` serves (int8:
    the s2d front; bf16: the engine with the block kernels, as the
    reference's ``tune`` builds it) at ``--depth-multiplier`` on seeded
    weights, over a seeded uint8 batch made on the card.  Export the
    printed options as ``TET_TORCH_COMPILER_OPTIONS`` to apply them.

    ``--step train`` times the train step ``Trainer.compile`` captures
    instead (:func:`_tune_train`), whose options are
    ``TET_TORCH_TRAIN_COMPILER_OPTIONS``."""
    import torch

    from tumblr_emotions_torch._device import resolve_device
    from tumblr_emotions_torch.config import get_preset
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.models import build_model, inception_v3
    from tumblr_emotions_torch.ops import serving as serving_lib
    from tumblr_emotions_torch.ops.inference import FusedInceptionV3
    from tumblr_emotions_torch.utils import compile_opts

    candidates = None
    if args.candidates:
        with open(args.candidates) as f:
            candidates = json.load(f)
        if not isinstance(candidates, list) or not all(isinstance(c, dict)
                                                       for c in candidates):
            raise SystemExit(f"--candidates {args.candidates} must hold a JSON list of "
                             "option->value objects")
    if args.step == "train":
        return _tune_train(args, candidates)
    dev = resolve_device(args.device)
    cfg = get_preset("fused_inference")
    if args.depth_multiplier != 1.0:
        cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=args.depth_multiplier))
    state = inception_v3.init_state(build_model(cfg, device="meta"), 0)
    state = {k: v.to(dev) for k, v in state.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    src = args.image_size   # the decoded-image size fed to the 0.875 crop
    raw = torch.randint(0, 256, (args.batch_size, src, src, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    # autotune serves the eager program (``program.fn``) with each candidate
    if args.engine == "int8":
        calib = preprocess_for_eval(raw[:64], dtype=torch.float32)
        program = serving_lib.build_forward(cfg, state, engine="int8", device=dev,
                                            calib_images=calib, front="s2d").program
    else:
        engine = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=True, device=dev)
        program = serving_lib.image_server(engine, device=dev).program

    def serving_program(raw_u8):
        return program.fn(raw_u8)[0]

    results = []

    def _record(opts, seconds):
        ips = args.batch_size * args.steps / seconds
        results.append({"options": opts, "images_per_sec": round(ips, 1)})
        log.info("candidate %s: %.1f img/s", json.dumps(opts), ips)

    best = compile_opts.autotune(
        serving_program, (raw,), candidates=candidates, steps=args.steps,
        repeats=args.repeats, cache_path=args.cache or None,
        key=f"serving/{args.engine}/b{args.batch_size}", on_result=_record, device=dev)
    print(json.dumps({
        "engine": args.engine, "batch_size": args.batch_size, "best_options": best,
        # A run served from the cache measures nothing.
        "best_images_per_sec": (max(r["images_per_sec"] for r in results)
                                if results else None),
        "candidates_measured": len(results),
        "from_cache": not results,
        "apply_hint": f"export {compile_opts.ENV_VAR}='{json.dumps(best)}'",
        "results": results,
    }))
    return 0


def _tune_train(args, candidates) -> int:
    """``tune --step train``, the reference's: joint_finetune in perf mode
    at ``--batch-size``, ``--image-size`` (the decoded size the train
    distortions crop) and ``--depth-multiplier``, on seeded weights and a
    seeded host batch (captions of 10 tokens); each candidate times the
    train step on the device (``Trainer.train_step_on_device``, the
    program ``Trainer.compile`` captures) on the same batch and per-update
    values, updating the same state in place (timing only: the reference's
    sweep also replays one set of arguments)."""
    import torch

    from tumblr_emotions_torch._device import resolve_device
    from tumblr_emotions_torch.config import get_preset
    from tumblr_emotions_torch.train.trainer import Trainer
    from tumblr_emotions_torch.utils import compile_opts

    dev = resolve_device(args.device)
    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=args.depth_multiplier),
                      train=cfg.train.replace(batch_size=args.batch_size,
                                              precision_mode="perf"))
    rng0 = np.random.RandomState(0)
    b, src = args.batch_size, args.image_size
    host = {"image": rng0.randint(0, 256, (b, src, src, 3), dtype=np.uint8),
            "label": rng0.randint(0, 15, (b,)).astype(np.int32),
            "lengths": np.full(b, 10, np.int32),
            "tokens": rng0.randint(0, 50, (b, 10)).astype(np.int32)}
    trainer = Trainer(cfg, preprocess="train", device=dev)
    state = trainer.init_state(_initial_state(cfg))
    names = sorted(host)
    batch = [torch.from_numpy(host[k]).to(dev) for k in names]
    scalars = trainer.optimizer.device_scalars(0, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def train_program(*args_):
        return trainer.train_step_on_device(state, dict(zip(names, args_[:-1])), gen, None,
                                            args_[-1])["loss"]

    results = []

    def _record(opts, seconds):
        ips = args.batch_size * args.steps / seconds
        results.append({"options": opts, "images_per_sec": round(ips, 1)})
        log.info("candidate %s: %.1f img/s", json.dumps(opts), ips)

    best = compile_opts.autotune(
        train_program, (*batch, scalars), candidates=candidates, steps=args.steps,
        repeats=args.repeats, cache_path=args.cache or None,
        key=f"train/joint/b{args.batch_size}", on_result=_record, device=dev,
        inference=False, generators=(gen,))
    print(json.dumps({
        "step": "train", "batch_size": args.batch_size, "best_options": best,
        # A run served from the cache measures nothing.
        "best_images_per_sec": (max(r["images_per_sec"] for r in results)
                                if results else None),
        "candidates_measured": len(results),
        "from_cache": not results,
        "apply_hint": f"export {compile_opts.TRAIN_ENV_VAR}='{json.dumps(best)}'",
        "results": results,
    }))
    return 0


def cmd_train_embeddings(args) -> int:
    """Train SGNS word2vec on the post captions (the alternative to public
    GloVe vectors) on the device; writes a .npy matrix for --embeddings."""
    from tumblr_emotions_torch.data.csv_dataset import load_posts_csv
    from tumblr_emotions_torch.data.vocab import Vocabulary
    from tumblr_emotions_torch.data.word2vec import Word2VecConfig, train_word2vec

    posts = load_posts_csv(args.csv)
    v = Vocabulary.load(args.vocab)
    cfg = Word2VecConfig(embed_dim=args.embed_dim, num_steps=args.steps)
    matrix = train_word2vec([p.text for p in posts], v, cfg, device=args.device)
    np.save(args.out, matrix)
    print(f"wrote {matrix.shape} embeddings to {args.out}")
    return 0


def cmd_scrape(args) -> int:
    from tumblr_emotions_torch.data.scraper import make_pytumblr_client, scrape_all

    client = make_pytumblr_client(args.consumer_key, args.consumer_secret)
    csv_path = scrape_all(client, max_posts_per_emotion=args.max_posts, out_dir=args.out)
    print(f"wrote {csv_path}")
    return 0


def cmd_convert_dataset(args) -> int:
    from tumblr_emotions_torch.data.convert import convert

    counts = convert(args.csv, args.images_dir, args.out, num_shards=args.num_shards,
                     valid_fraction=args.valid_fraction, record_format=args.format)
    print(json.dumps(counts))
    return 0


def cmd_build_vocab(args) -> int:
    from tumblr_emotions_torch.data.csv_dataset import load_posts_csv
    from tumblr_emotions_torch.data.vocab import build_vocabulary

    posts = load_posts_csv(args.csv)
    v = build_vocabulary((p.text for p in posts), max_size=args.max_size,
                         min_freq=args.min_freq)
    v.save(args.out)
    print(f"wrote {v.size} tokens to {args.out}")
    return 0


def cmd_export_checkpoint(args) -> int:
    """Export the latest step checkpoint as a slim (TF name-based)
    checkpoint of the Inception tower, the inverse of --warmstart."""
    from tumblr_emotions_torch.models.joint_model import tower_state
    from tumblr_emotions_torch.train.trainer import Trainer
    from tumblr_emotions_torch.utils import checkpoint as ckpt_lib

    cfg = _build_config(args)
    vocab = _load_vocab(args, cfg) if (cfg.model in ("text", "joint") and args.vocab) else None
    if vocab is not None:
        cfg = cfg.replace(text=cfg.text.replace(vocab_size=vocab.size))
    trainer = Trainer(cfg, device=args.device)
    restored = trainer.restore_latest(trainer.init_state(_initial_state(cfg)))
    if restored is None:
        raise SystemExit(f"no checkpoint in {cfg.train.checkpoint_dir}")
    weights = _weights(restored)
    if cfg.model == "joint":
        weights = tower_state(weights)
    path = ckpt_lib.save_as_slim_checkpoint(weights, args.out)
    print(f"wrote slim checkpoint {path} (step {restored.step})")
    return 0


def parser() -> argparse.ArgumentParser:
    """The CLI's argument parser (each command's namespace has ``fn``)."""
    parser = argparse.ArgumentParser(prog="tumblr_emotions_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    for name, fn in [("train", cmd_train), ("eval", cmd_eval), ("predict", cmd_predict),
                     ("analyze", cmd_analyze)]:
        p = sub.add_parser(name)
        _add_common(p)
        if name == "predict":
            p.add_argument("--image", default="")
            p.add_argument("--text", default="")
        if name == "analyze":
            p.add_argument("--plot", default="",
                           help="write the circumplex figure (PNG/SVG) here (needs matplotlib)")
            p.add_argument("--examples", default="",
                           help="write the qualitative-examples markdown report (per-emotion "
                                "top-k hits/misses + confusion pairs) here")
            p.add_argument("--top-k", type=int, default=5,
                           help="examples per emotion in the report")
        if name == "train":
            p.add_argument("--eval-records", default="",
                           help="eval-split TFRecord glob: evaluate at every checkpoint "
                                "interval (in-train eval)")
            p.add_argument("--eval-csv", default="",
                           help="eval-split posts CSV (text-only models)")
            p.add_argument("--prefetch-depth", type=int, default=0,
                           help="batches kept on the device by a background feeder "
                                "(0: no prefetch)")
        if name == "eval":
            p.add_argument("--follow", action="store_true",
                           help="continuous mode: evaluate each new checkpoint "
                                "(slim evaluation_loop)")
            p.add_argument("--eval-interval", type=float, default=30.0,
                           help="--follow poll interval (seconds)")
            p.add_argument("--eval-timeout", type=float, default=0.0,
                           help="--follow: stop after this long with no new checkpoint "
                                "(0 = wait forever)")
            p.add_argument("--out", default="",
                           help="append each summary (count, accuracy, loss, confusion) "
                                "as a JSON line here")
        p.set_defaults(fn=fn)

    p = sub.add_parser("convert-dataset")
    p.add_argument("--csv", required=True)
    p.add_argument("--images-dir", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--num-shards", type=int, default=5)
    p.add_argument("--valid-fraction", type=float, default=0.1)
    p.add_argument("--format", choices=["tfrecord", "arrayrecord"], default="tfrecord")
    p.set_defaults(fn=cmd_convert_dataset)

    for name in ("infer", "serve"):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--engine", choices=["int8", "bf16", "parity"], default="int8")
        p.add_argument("--front", choices=["s2d", "uint8", "float"], default="s2d",
                       help="int8 preprocess front: s2d (the benchmarked default), uint8 "
                            "(all-int8), float (normal layout)")
        p.add_argument("--dp", action="store_true",
                       help="split each batch over every visible card (int8 and bf16 "
                            "engines; the batch must be a multiple of the card count)")
        if name == "infer":
            p.add_argument("--out", default="", help="output JSONL path")
            p.add_argument("--probs-out", default="",
                           help="write the probabilities unrounded as a .npy here")
            p.add_argument("--validate", action="store_true",
                           help="also report int8-vs-bf16 quantization deltas")
            p.set_defaults(fn=cmd_infer)
        else:
            p.add_argument("--host", default="0.0.0.0")
            p.add_argument("--port", type=int, default=8080,
                           help="0 binds an ephemeral port (printed as JSON)")
            p.add_argument("--serve-batch-size", type=int, default=64,
                           help="fixed device batch size (partial batches padded)")
            p.add_argument("--max-delay-ms", type=float, default=5.0,
                           help="max micro-batching wait after the first request")
            p.add_argument("--host-size", type=int, default=347,
                           help="host-side decoded/resized image side")
            p.add_argument("--request-timeout", type=float, default=60.0)
            p.add_argument("--max-queue", type=int, default=0,
                           help="bounded request queue; full -> fast-fail 503 "
                                "(0 = default 8 device batches of headroom)")
            p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("build-vocab")
    p.add_argument("--csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-size", type=int, default=50_000)
    p.add_argument("--min-freq", type=int, default=2)
    p.set_defaults(fn=cmd_build_vocab)

    p = sub.add_parser("export-checkpoint")
    _add_common(p)
    p.add_argument("--out", required=True, help="output slim .ckpt path prefix")
    p.set_defaults(fn=cmd_export_checkpoint)

    p = sub.add_parser("parity")
    p.add_argument("--warmstart", required=True,
                   help="slim .ckpt with a Logits head (e.g. an ImageNet checkpoint)")
    p.add_argument("--goldens", default="", help=".npz with raw/images + reference logits")
    p.add_argument("--images", default="", help=".npz with raw/images (for --save-goldens)")
    p.add_argument("--save-goldens", default="",
                   help="write goldens from this package's forward")
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--depth-multiplier", type=float, default=1.0,
                   help="match a reduced-width checkpoint (tests)")
    p.add_argument("--min-depth", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("train-embeddings")
    p.add_argument("--csv", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--embed-dim", type=int, default=200)
    p.add_argument("--steps", type=int, default=20_000)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_train_embeddings)

    p = sub.add_parser("tune")
    p.add_argument("--step", choices=["serving", "train"], default="serving",
                   help="serving: the served program; train: the captured train step "
                        "(joint_finetune, perf mode)")
    p.add_argument("--engine", choices=["int8", "bf16"], default="int8")
    p.add_argument("--batch-size", type=int, default=768)
    p.add_argument("--image-size", type=int, default=347,
                   help="decoded-JPEG size fed to the 0.875 crop")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--cache", default=".tet_torch_tune.json",
                   help="JSON cache path ('' to disable)")
    p.add_argument("--candidates", default="",
                   help="JSON file with a list of option->value objects (default: the "
                        "built-in ladder, cuda_graph false and true)")
    p.add_argument("--depth-multiplier", type=float, default=1.0,
                   help="tune a reduced-width tower (tests)")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("scrape")
    p.add_argument("--consumer-key", required=True)
    p.add_argument("--consumer-secret", default="")
    p.add_argument("--max-posts", type=int, default=1000)
    p.add_argument("--out", default="scraped")
    p.set_defaults(fn=cmd_scrape)
    return parser


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parser().parse_args(argv)
    try:
        return args.fn(args)
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
