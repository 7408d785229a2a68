"""Model configurations: ``base.ModelConfig`` and the ten registered
architectures (``base.registry()`` / ``base.get_config``)."""
