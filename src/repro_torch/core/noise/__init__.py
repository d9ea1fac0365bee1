"""OS-noise modelling: recorded-trace distributions, host sampling, and
wall-clock noise injection into real solver runs."""
from repro_torch.core.noise.injection import (  # noqa: F401
    NoiseHook,
    make_noise_hook,
)
from repro_torch.core.noise.sampling import (  # noqa: F401
    sample_np,
    scale_distribution,
)
from repro_torch.core.noise.traces import EmpiricalDistribution  # noqa: F401
