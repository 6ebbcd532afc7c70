"""Training-side modules of the port.  So far the batch-1 ``Predictor``
(``train/predict.py``); the trainer comes with the training slice."""
