from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state  # noqa: F401
