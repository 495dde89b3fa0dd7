"""Declarative front door of the port: spec, registry, facade."""
from repro_torch.api.federation import (Federation,  # noqa: F401
                                        build_clients, build_corpus,
                                        build_lm_clients, build_lm_corpus,
                                        heldout_elbo_per_token,
                                        heldout_perplexity,
                                        heldout_xent_per_token,
                                        max_param_dev, resolve_device)
from repro_torch.api.registry import (  # noqa: F401
    BENCH_SCENARIOS, SCENARIOS, register_scenario, scenario_names,
    scenario_spec)
from repro_torch.api.spec import (  # noqa: F401
    SPEC_VERSION, DataSpec, ExecutionSpec, FederationSpec, MeshSpec,
    ModelSpec, PartitionSpec, ScheduleSpec, ServerOptSpec, TransformsSpec,
    parse_int_tuple, spec_replace)
