from robustbnns_tpu_torch.attacks.gradient_attacks import (
    attack,
    attack_evaluation,
    fgsm_attack,
    load_attack,
    pgd_attack,
    save_attack,
)
from robustbnns_tpu_torch.attacks.measures import softmax_difference, softmax_robustness

__all__ = [
    "softmax_difference",
    "softmax_robustness",
    "fgsm_attack",
    "pgd_attack",
    "attack",
    "attack_evaluation",
    "save_attack",
    "load_attack",
]
