"""Strict dataclass configuration.

Counterpart of ``iadmm_tpu/config.py``: the same fields, defaults, YAML
schema and ``run_name()``, so the same ``configs/*.yaml`` drive both
packages.  Unknown keys raise.

The port accepts every key of the JAX package.  Some select routes it has
not ported; :meth:`ExperimentConfig.check_ported` raises
``NotImplementedError`` for a value that needs one (see ROADMAP.md).
``epoch_scan`` and ``preload`` only choose how the JAX package dispatches
an epoch and where it keeps the train split; the port always runs its
per-batch route and converts each batch when it is used, whatever they say.
"""

from __future__ import annotations

import dataclasses

try:
    import yaml
    _HAVE_YAML = True
except Exception:  # pragma: no cover
    _HAVE_YAML = False


@dataclasses.dataclass
class ExperimentConfig:
    """Every knob of the JAX package's configuration, with its default."""

    # --- optimizee / problem ---
    prob_type: str = "QP"
    num_var: int = 100
    num_eq: int = 0
    num_ineq: int = 0
    qplib_num: int = 0              # QPLIB instance id (prob_type='QPLIB')
    data_size: int = 1000
    data_root: str = "./datasets"

    # --- model ---
    model_name: str = "lstm"        # cell registry key
    input_dim: int = 2
    hidden_dim: int = 800
    sigma: float = 6e-6
    inner_T: int = 50               # multi_layer_lstm only
    scaling: bool = True
    scaling_ites: int = 10

    # --- training ---
    outer_T: int = 100
    truncated_length: int = 100
    batch_size: int = 2
    lr: float = 5e-5
    weight_decay: float = 0.0
    clip_grad_norm: float = 0.0     # >0: global-norm gradient clipping
    spike_rollback_factor: float = 25.0  # restore the gated checkpoint when
                                    # the epoch loss exceeds this x the
                                    # recent median (0 = off)
    num_epoch: int = 1000
    eq_tol: float = 0.2
    ineq_tol: float = 0.2
    early_stop_mode: str = "min"
    patience: int = 100
    val_frac: float = 0.01
    test_frac: float = 0.05
    seed: int = 17
    save_dir: str = "./results/"

    # --- test / inference ---
    test_outer_T: int = 100
    test_batch_size: int = 1
    feas_rest: bool = False
    feas_rest_num: int = 20
    stage2_rho: float = 0.0         # 0 = last learned rho; >0 = fixed rho_bar
    save_sol: bool = False
    theory: bool = False            # per-iteration theory-condition traces

    # --- knobs of the JAX package's own routes ---
    epoch_scan: bool = True         # JAX: whole-epoch compiled scan; the
                                    # port runs per batch either way
    num_devices: int = 0            # 0 = all visible devices; the port
                                    # runs on one
    model_devices: int = 1          # tensor-parallel factor
    sparse: bool = False            # sparse problem data through the solver
    sparse_format: str = "bcoo"     # 'bcoo' | 'bsr'
    use_pallas: bool = False        # the fused cell kernel (CUDA in the port)
    gate_dtype: str = "float32"     # 'bfloat16' enables bf16 gate products
    matvec_mode: str = "highest"    # KKT-feature matvecs: highest|default|bf16
    remat: bool = False             # recompute each step in the backward
    resume: bool = False            # resume training from the run checkpoint
    preload: str = "auto"           # JAX: train split on device once; the
                                    # port converts per batch either way
    preload_dtype: str = "float32"  # Q/A0 storage of the preloaded stack
    train_hours: float = 0.0        # wall-clock training budget (0 = off)
    train_backend: str = "step"     # 'fused' = the training kernels
                                    # (kernels/train_rollout.py)
    log_every: int = 1

    def run_name(self) -> str:
        """Run-keyed checkpoint naming, the JAX package's."""
        pt = self.prob_type
        if pt in ("QP", "QP_RHS"):
            core = f"{pt}_{self.num_var}_{self.num_ineq}_{self.num_eq}"
        elif pt in ("Random_QP", "SVM", "Portfolio"):
            core = f"{pt}_{self.num_var}_{self.num_ineq}"
        elif pt == "Equality_QP":
            core = f"{pt}_{self.num_var}_{self.num_eq}"
        elif pt == "QPLIB":
            core = f"QPLIB_{self.qplib_num}"
        elif pt.startswith("MM_"):
            core = f"{pt}_{self.num_var}"
        else:
            core = pt
        return f"{core}_{self.outer_T}_{self.hidden_dim}"

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for a value whose route the port
        does not have yet."""
        unported = []
        if self.num_devices > 1 or self.model_devices > 1:
            unported.append("num_devices/model_devices > 1 (data and "
                            "tensor parallelism)")
        if self.sparse:
            unported.append("sparse=True (the BCOO/BSR routes)")
        if self.preload_dtype != "float32":
            unported.append(f"preload_dtype={self.preload_dtype!r}")
        if self.train_backend not in ("step", "fused"):
            raise ValueError(f"unknown train_backend {self.train_backend!r}")
        if unported:
            raise NotImplementedError(
                "not ported to PyTorch yet: " + "; ".join(unported)
                + "; see ROADMAP.md")

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "ExperimentConfig":
        if not _HAVE_YAML:
            raise RuntimeError("pyyaml not available")
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        raw.update(overrides)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "ExperimentConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**raw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
