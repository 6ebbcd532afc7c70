"""Training-side modules of the port: the trainer and its optimizers
(``train/trainer.py``, ``train/optim.py``) and the batch-1 ``Predictor``
(``train/predict.py``)."""
