"""Channel, power control and quantization — the paper's core layer."""
