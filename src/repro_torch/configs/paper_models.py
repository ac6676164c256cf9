"""The paper's own experiment models (Section VI): hyper-parameter records.

A copy of ``repro.configs.paper_models`` (the port imports nothing of the
JAX package).  The paper uses multinomial logistic regression (MCLR), a
3-layer MLP and a character LSTM; their parameter factories and apply
functions live in ``repro_torch.models.small``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SmallModelConfig:
    name: str
    kind: str          # mclr | mlp | lstm
    n_features: int
    n_classes: int
    hidden: int = 0
    vocab: int = 0     # lstm only
    seq_len: int = 0   # lstm only
    embed: int = 0


# paper: MNIST / synthetic use MCLR on 784/60-dim features, 10 classes
MCLR = SmallModelConfig(name="paper-mclr", kind="mclr",
                        n_features=60, n_classes=10)
MLP = SmallModelConfig(name="paper-mlp", kind="mlp",
                       n_features=60, n_classes=10, hidden=128)
# paper: Sent140 / Shakespeare use an LSTM; character-level next-token
LSTM = SmallModelConfig(name="paper-lstm", kind="lstm",
                        n_features=0, n_classes=80, vocab=80,
                        seq_len=80, hidden=128, embed=64)
