"""Scene/camera tensors and camera math."""
