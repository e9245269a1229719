"""Adaptive self-speculative decoding: acceptance-driven draft control.

PyTorch counterpart of ``repro.autotune.speculation``, line for line (it
holds no tensor code).

The engine's speculative round drafts ``k - 1`` tokens with an
approximate attention pass and verifies them with one multi-query exact
pass; exact-match acceptance makes the committed stream byte-identical
to greedy decode *at any draft length and any draft profile* — the two
knobs only move the work/acceptance tradeoff. That makes them safe to
tune online, which is what :class:`SpecController` does (the Energon
idea applied to the HDP draft): keep a running acceptance-rate EMA and,
per round, pick

* ``k`` — the round length (1 draft call proposes ``k - 1`` tokens; at
  ``k = 1`` the round degenerates to one exact decode step, speculation
  effectively off), scaled linearly with the EMA between configured
  bounds; and
* the :class:`~repro_torch.attention.DraftProfile` — prune-threshold overrides
  for the draft pass: when acceptance is high the draft can afford to
  prune *more* aggressively (rho_b / tau_h raised), when acceptance
  collapses the overrides are dropped so the draft matches the exact
  pass's thresholds and acceptance recovers.

Both outputs are constants of a captured round in the engine (the round
length is its number of draft steps, the profile's thresholds are folded
into the HDP config of its draft calls), so the controller deliberately
quantizes to a *small finite set* of (k, profile) pairs — at most
``1 + 3 x (k_max - 1)`` CUDA graphs per engine (k = 1 has no draft step,
so no tier), each captured once and replayed.

The ``scores`` field of the profile is never varied: the draft-scout
page pool is allocated at cache-build time based on it, so flipping it
mid-serve would need a cache rebuild, not just a re-capture.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.attention.spec import DraftProfile
from repro_torch.core.config import HDPConfig


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Controller knobs (defaults tuned for the serving tests' scale).

    Attributes:
      k_min / k_max: round-length bounds (k tokens committed per accepted
        round; k_min=1 lets the controller switch speculation off).
      beta: EMA retention per round (higher = slower adaptation).
      init_ema: optimistic start — the first rounds draft at full length
        and the measured acceptance walks the EMA down if undeserved.
      aggressive_above / conservative_below: EMA thresholds picking the
        draft profile tier; between them the engine's base profile runs.
      rho_step / tau_step: how far the aggressive tier raises the HDP
        survival thresholds above the base draft overlay.
    """

    k_min: int = 1
    k_max: int = 4
    beta: float = 0.7
    init_ema: float = 1.0
    aggressive_above: float = 0.8
    conservative_below: float = 0.35
    rho_step: float = 0.1
    tau_step: float = 0.05

    def __post_init__(self):
        if not (1 <= self.k_min <= self.k_max):
            raise ValueError(
                f"need 1 <= k_min <= k_max, got ({self.k_min}, {self.k_max})")
        if not (0.0 <= self.beta < 1.0):
            raise ValueError(f"beta must be in [0, 1), got {self.beta}")


class SpecController:
    """Acceptance-EMA draft-length + draft-profile chooser.

    Parameters
    ----------
    base: the engine's configured draft profile (the middle tier).
    hdp: the exact pass's HDP config — the threshold baseline that the
        aggressive tier steps up from when ``base`` has no override.
    cfg: controller knobs.
    """

    def __init__(self, base: DraftProfile, hdp: Optional[HDPConfig] = None,
                 cfg: Optional[SpecConfig] = None):
        self.cfg = cfg if cfg is not None else SpecConfig()
        self.base = base
        self.ema = float(self.cfg.init_ema)
        self.rounds = 0
        self.drafted_total = 0
        self.accepted_total = 0
        self.k_total = 0

        rho0 = base.rho_b if base.rho_b is not None \
            else (hdp.rho_b if hdp is not None else 0.5)
        tau0 = base.tau_h if base.tau_h is not None \
            else (hdp.tau_h if hdp is not None else 0.0)
        self.conservative = DraftProfile(scores=base.scores)
        self.aggressive = DraftProfile(
            rho_b=min(0.95, rho0 + self.cfg.rho_step),
            tau_h=tau0 + self.cfg.tau_step,
            scores=base.scores)

    # ----------------------------------------------------------------- plan
    def plan(self) -> Tuple[int, DraftProfile]:
        """(k, draft profile) for the next round."""
        c = self.cfg
        k = 1 + int(round(self.ema * (c.k_max - 1)))
        k = max(c.k_min, min(c.k_max, k))
        if self.ema >= c.aggressive_above:
            profile = self.aggressive
        elif self.ema < c.conservative_below:
            profile = self.conservative
        else:
            profile = self.base
        self.k_total += k
        return k, profile

    # --------------------------------------------------------------- update
    def update(self, accepted: int, drafted: int) -> None:
        """Fold one round's outcome in.

        ``accepted`` counts accepted *draft* tokens (the verify step's
        guaranteed token is not a speculation win); ``drafted <= 0``
        rounds (k = 1, no draft ran) leave the EMA untouched — no
        evidence either way.
        """
        self.rounds += 1
        if drafted <= 0:
            return
        self.drafted_total += int(drafted)
        self.accepted_total += int(accepted)
        rate = min(max(accepted / drafted, 0.0), 1.0)
        self.ema = self.cfg.beta * self.ema + (1.0 - self.cfg.beta) * rate

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        return {
            "acceptance_ema": self.ema,
            "rounds": self.rounds,
            "drafted": self.drafted_total,
            "accepted": self.accepted_total,
            "acceptance_rate": (self.accepted_total / self.drafted_total
                                if self.drafted_total else None),
            "draft_len_mean": (self.k_total / self.rounds
                               if self.rounds else None),
        }
