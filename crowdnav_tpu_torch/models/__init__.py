"""Network definitions for all agent families."""

from crowdnav_tpu_torch.models.networks import (  # noqa: F401
    DeterministicActor,
    DoubleCritic,
    GaussianActor,
    QCritic,
    QNetwork,
    ValueNetwork,
)
