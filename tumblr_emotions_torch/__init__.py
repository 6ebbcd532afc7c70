"""tumblr_emotions_torch: the PyTorch/CUDA port of tumblr_emotions_tpu for an
NVIDIA H100 (Hopper, sm_90a).

It imports torch and numpy only, never JAX or the JAX package, which stays
the reference that the tests hold this package against.  Public layouts
(NHWC activations) and names (slim scopes) are the JAX package's.  Entry
points take ``device`` (default ``"cuda"``) and raise when no card is
present.

Layer map:
  entry        -> cli (python -m tumblr_emotions_torch.cli: train, eval,
                  predict, infer, serve, convert-dataset, build-vocab,
                  export-checkpoint)
  front end    -> server (EmotionHTTPServer, BatchedPredictor: posts over
                  HTTP in fixed-size device batches), train.predict
                  (Predictor, batch 1)
  entry points -> ops.serving   (image_server, joint_server, build_forward)
  engines      -> ops.quant (QuantizedInceptionV3, int8, the default; its
                  uint8 front), ops.inference (FusedInceptionV3, bf16),
                  models.inception_v3 (the f32 tower)
  text, fusion -> models.text_model (TextEmotionModel), models.joint_model
                  (DeepSentimentModel.fuse)
  training     -> train.trainer (Trainer: fit, evaluate; the models in train
                  mode; step checkpoints and resume), train.optim (the
                  optimizers as optax computes them), utils.metrics
                  (streaming counts and confusion), utils.checkpoint (TF
                  tensor bundles: step checkpoints, slim warm start and
                  export), utils.crc32c + csrc/crc32c.cc
  kernels      -> ops.int8_conv + csrc/int8_conv.cu, ops.int8_pool +
                  csrc/int8_pool.cu, ops.fused_inception + csrc/inception_blocks.cu
  data         -> data.jpeg + csrc/jpeg_decode.cc (host JPEG decode and
                  the PIL-bilinear resize, bit for bit, built by g++),
                  data.records (TFRecords, tf.Example), data.convert and
                  data.csv_dataset, data.pipeline (grain's record order by
                  data.index_shuffle, resumable batches, the device feed),
                  data.preprocessing
                  (eval, s2d, the train distortions), data.vocab (tokenizer, vocabulary, embedding
                  loaders), convert (weights from JAX)
"""

__version__ = "0.1.0"

from tumblr_emotions_torch.config import (  # noqa: F401
    EMOTIONS,
    NUM_CLASSES,
    PRESETS,
    Config,
    DataConfig,
    ImageConfig,
    TextConfig,
    TrainConfig,
    get_preset,
)
from tumblr_emotions_torch.models import (  # noqa: F401
    DeepSentimentModel,
    InceptionV3,
    TextEmotionModel,
    build_model,
)
from tumblr_emotions_torch.ops.fused_inception import (  # noqa: F401
    fold_batchnorm,
    fused_inception_a,
    fused_inception_b,
)
from tumblr_emotions_torch.ops.inference import FusedInceptionV3  # noqa: F401
from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3  # noqa: F401
from tumblr_emotions_torch.ops.serving import (  # noqa: F401
    build_forward,
    image_server,
    joint_server,
)
