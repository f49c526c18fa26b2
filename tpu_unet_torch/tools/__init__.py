"""Command-line tools of the port that run on the card: ``profile_step``
(the train step's device time by kernel) and ``train_demo`` (the quality
gates), the counterparts of the JAX package's ``tools/profile_step.py`` and
``tools/train_demo.py``."""
