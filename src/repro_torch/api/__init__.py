"""Declarative front door of the port: spec, registry, facade."""
from repro_torch.api.federation import (Federation,  # noqa: F401
                                        build_clients, build_corpus,
                                        build_lm_clients, build_lm_corpus,
                                        heldout_elbo_per_token,
                                        heldout_perplexity,
                                        heldout_xent_per_token,
                                        max_param_dev, resolve_device)
from repro_torch.api.registry import (scenario_names,  # noqa: F401
                                      scenario_spec)
from repro_torch.api.spec import (DataSpec, ExecutionSpec,  # noqa: F401
                                  FederationSpec, ModelSpec, PartitionSpec,
                                  ScheduleSpec, ServerOptSpec,
                                  TransformsSpec, spec_replace)
