"""YOLOv8 training on one device: loss, optimizer, trainer, checkpoints."""
