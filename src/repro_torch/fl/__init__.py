from .cnn import (cnn_accuracy, cnn_forward, cnn_loss, init_cnn,
                  params_from_jax, params_to_jax)
from .loop import FLConfig, FLResult, RoundLog, local_adagrad, run_fl
from .models import ModelSpec, as_model_spec

__all__ = ["FLConfig", "FLResult", "ModelSpec", "RoundLog", "as_model_spec",
           "cnn_accuracy", "cnn_forward", "cnn_loss", "init_cnn",
           "local_adagrad", "params_from_jax", "params_to_jax", "run_fl"]
