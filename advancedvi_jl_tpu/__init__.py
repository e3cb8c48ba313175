"""advancedvi_jl_tpu — a variational-inference framework in JAX.

A from-scratch JAX/XLA framework covering the full algorithm surface of
TuringLang/AdvancedVI.jl (see SURVEY.md for the structural analysis of the
reference), redesigned for an accelerator:

- families, optimizer states, and algorithm states are pytrees;
- the whole SGD step (sample -> log-density -> entropy -> grad -> update ->
  operator -> averaging) is one jitted XLA program, `lax.scan`-able;
- the Monte-Carlo sample axis and the data minibatch axis are device-mesh
  axes with psum reductions (parallel/);
- measure-space (natural-gradient) algorithms are fused batched linear
  algebra (cuBLAS/cuSOLVER on a GPU).
"""

from .core.problem import (
    CustomGradTarget,
    FnTarget,
    ORDER_GRAD,
    ORDER_HESS,
    ORDER_JAX,
    ORDER_VALUE_ONLY,
    fn_target,
    log_density,
    log_density_and_grad,
    subsample,
)
from .core.pytree import (
    pytree_dataclass,
    static_field,
    tree_stop_gradient,
)
from .core.transforms import (
    Exp,
    Identity,
    Ordered,
    Sigmoid,
    Softplus,
    Stacked,
    StickBreakingSimplex,
    TransformedDistribution,
    TransformedTarget,
    stacked,
)
from .families.base import Laplace, Normal, StudentT
from .families.location_scale import (
    FullRankGaussian,
    FullRankLocationScale,
    MeanFieldGaussian,
    MeanFieldLocationScale,
)
from .families.mixture import (
    MixtureELBO,
    MixtureFullRank,
    MixtureMeanField,
    mixture_fullrank,
    mixture_meanfield,
)
from .families.flows import (
    CouplingFlowFamily,
    FlowELBO,
    PlanarFlowFamily,
    RadialFlowFamily,
    coupling_flow,
    planar_flow,
    radial_flow,
)
from .families.blockdiag import BlockDiagGaussian, BlockDiagLocationScale
from .families.local import (
    GlobalLocalFamily,
    PerDatapointMeanField,
    per_datapoint_meanfield,
)
from .families.low_rank import LowRankGaussian, LowRankLocationScale
from .objectives.entropy import (
    CLOSED_FORM,
    CLOSED_FORM_ZERO_GRAD,
    MONTE_CARLO,
    STL,
    STL_ZERO_GRAD,
    estimate_entropy,
)
from .algorithms.pathfinder import (
    PathfinderResult,
    multipath_pathfinder,
    pathfinder,
)
from .objectives.iwelbo import IWELBO, KLMinIWRepGradDescent
from .objectives.repgradelbo import RepGradELBO
from .objectives.scoregradelbo import ScoreGradELBO
from .objectives.subsampled import SubsampledObjective
from .optim.averaging import NoAveraging, PolynomialAveraging
from .optim.operators import (
    ClipScale,
    IdentityOperator,
    ProximalLocationScaleEntropy,
)
from .optim.rules import cocob, descent, dog, dowg, stepsize_from_opt_state
from .algorithms.paramspace import (
    ADVI,
    BBVI,
    KLMinRepGradDescent,
    KLMinRepGradProxDescent,
    KLMinScoreGradDescent,
    ParamSpaceSGD,
)
from .algorithms.measure_space import (
    FisherMinBatchMatch,
    KLMinNaturalGradDescent,
    KLMinSqrtNaturalGradDescent,
    KLMinWassFwdBwd,
)
from .algorithms.termination import WithTermination, elbo_at_least
from .core.external import ExternalTarget
from .core.factorized import FactorizedTarget, factorized_target
from .estimate import estimate_objective
from .optimize import DivergenceError, optimize
from .parallel.mesh import DATA_AXIS, MC_AXIS, make_vi_mesh
from .subsampling import ReshufflingBatchSubsampling
from .utils.checkpoint import restore_state, save_state
from .utils.data import HostDataLoader, PrefetchingLoader, optimize_streamed
from .utils.diagnostics import importance_diagnostics, pareto_khat
from .utils.progress import ProgressMeter

from . import ppl  # model-ingestion DSL + numpyro bridge (L8)

__version__ = "0.5.0"
