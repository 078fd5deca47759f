from .cnn import (cnn_accuracy, cnn_forward, cnn_loss, init_cnn,
                  params_from_jax, params_to_jax)
from .loop import (FLConfig, FLResult, RoundLog, deterministic_cudnn,
                   local_adagrad, local_delta, run_fl, run_fl_sequential)
from .models import ModelSpec, as_model_spec

__all__ = ["FLConfig", "FLResult", "ModelSpec", "RoundLog", "as_model_spec",
           "cnn_accuracy", "cnn_forward", "cnn_loss", "deterministic_cudnn",
           "init_cnn", "local_adagrad", "local_delta", "params_from_jax",
           "params_to_jax", "run_fl", "run_fl_sequential"]
