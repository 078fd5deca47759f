from .cfmmimo import (CFmMIMOConfig, ChannelRealization, computation_latency,
                      draw_positions, large_scale_fading, make_channel,
                      uplink_latency)

__all__ = ["CFmMIMOConfig", "ChannelRealization", "computation_latency",
           "draw_positions", "large_scale_fading", "make_channel",
           "uplink_latency"]
