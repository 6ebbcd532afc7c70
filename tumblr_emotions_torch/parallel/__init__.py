from tumblr_emotions_torch.parallel.mesh import Mesh, create_mesh  # noqa: F401
