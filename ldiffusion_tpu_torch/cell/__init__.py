"""The cell level: instance proposers and the instance classifier."""
from ldiffusion_tpu_torch.cell.instance import (  # noqa: F401
    DistanceWatershedProposer,
    FlowNetProposer,
    InstanceProposer,
)
from ldiffusion_tpu_torch.cell.classifier import CellSegClassifier, CellTrainer  # noqa: F401
