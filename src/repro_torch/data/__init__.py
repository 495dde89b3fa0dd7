from repro_torch.data.synthetic_lda import (SyntheticLDA,  # noqa: F401
                                            generate_lda_corpus)
