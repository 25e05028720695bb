"""Objectives of the port: batched ``eval_fn(vectors f32[n, d], budget) ->
f32[n]`` functions and ``StatefulEval`` trainers for ``FusedBOHB``.

Exports as ``hpbandster_tpu/workloads/__init__.py`` does, the
sequence-parallel ``transformer_forward_seq_parallel`` included.
"""

from hpbandster_tpu_torch.workloads.toys import (  # noqa: F401
    BRANIN_OPT,
    HARTMANN6_OPT,
    branin,
    branin_dict,
    branin_from_vector,
    branin_space,
    hartmann6,
    hartmann6_from_vector,
    hartmann6_space,
)
from hpbandster_tpu_torch.workloads.cnn import (  # noqa: F401
    CNN_TARGET_VAL_ACCURACY,
    CNNConfig,
    cnn_forward,
    cnn_space,
    decode_cnn_hparams,
    init_cnn_params,
    make_cnn_accuracy_fn,
    make_cnn_error_fn,
    make_cnn_eval_fn,
    make_image_dataset,
)
from hpbandster_tpu_torch.workloads.resnet import (  # noqa: F401
    ResNetConfig,
    decode_resnet_hparams,
    init_resnet_params,
    make_resnet_eval_fn,
    resnet_forward,
    resnet_space,
)
from hpbandster_tpu_torch.workloads.ensemble import (  # noqa: F401
    EnsembleState,
    ensemble_lane_bytes,
    make_mlp_ensemble,
    shard_ensemble_state,
    make_uninterrupted_train_fn,
)
from hpbandster_tpu_torch.workloads.mlp import (  # noqa: F401
    MLPConfig,
    batched_sgd_train_step,
    sgd_train_step_batch,
    decode_mlp_hparams,
    init_mlp_params,
    make_mlp_eval_fn,
    make_synthetic_dataset,
    mlp_forward,
    mlp_space,
)
from hpbandster_tpu_torch.workloads.transformer import (  # noqa: F401
    TRANSFORMER_TARGET_VAL_ACCURACY,
    TransformerConfig,
    make_copy_dataset,
    make_transformer_accuracy_fn,
    make_transformer_error_fn,
    make_transformer_eval_fn,
    transformer_forward,
    transformer_forward_seq_parallel,
    transformer_space,
)
from hpbandster_tpu_torch.workloads.teacher import (  # noqa: F401
    TARGET_VAL_ACCURACY,
    TeacherConfig,
    make_teacher_accuracy_fn,
    make_teacher_dataset,
    make_teacher_eval_fn,
    teacher_space,
)
