"""k-failure backup allocation as a policy wrapper (counterpart of
``repro/core/faults/backup.py``).

:func:`with_backup` wraps a mapping policy so that every task assigned a
primary machine also gets ``k`` backup machines, nominated at assignment
time by least expected completion (``avail_base + EET``) over healthy
machines other than the primary. Backups are passive: when the primary
dies mid-run, the engine's ``faults`` stage enqueues the orphan directly
on its first healthy, non-full backup instead of sending it back to
dispatch. Mapping itself is the base policy's, unchanged; without a
dynamics the engine skips the backup machinery and the wrapper is inert.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BackupPolicy:
    """A mapping policy plus k-failure backup nomination (see module doc).

    ``backup_k`` is the attribute the engine keys the backup machinery on
    (0 = none). ``with_fused_map`` and ``with_fused_phase1`` rewrap the
    base policy and keep this wrapper outermost, so the count survives
    them.
    """

    base: object
    k: int = 1

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"backup count k must be >= 1, got {self.k}")
        if not (callable(self.base) or hasattr(self.base, "select")):
            raise TypeError(
                f"with_backup needs a mapping policy, got {self.base!r}")
        object.__setattr__(self, "k", int(self.k))

    @property
    def backup_k(self) -> int:
        return self.k

    def select(self, ctx):
        return self.base.select(ctx)

    def __call__(self, now, pending, task_type, deadline, view, sysarr,
                 suffered, task_type32=None):
        return self.base(now, pending, task_type, deadline, view, sysarr,
                         suffered, task_type32=task_type32)

    def describe(self):
        from repro_torch.core import policy as policy_mod

        return policy_mod.describe(self.base)._replace(backup_k=self.k)

    @property
    def supports_phase1_impl(self) -> bool:
        return getattr(self.base, "supports_phase1_impl", False)

    def with_phase1_impl(self, impl) -> "BackupPolicy":
        if not self.supports_phase1_impl:
            return self
        return dataclasses.replace(self, base=self.base.with_phase1_impl(impl))


def with_backup(policy_or_name, k: int = 1) -> BackupPolicy:
    """Wrap a policy (or registered policy name) with k-failure backups.

        from repro_torch.core import faults
        pol = faults.with_backup("FELARE", k=1)
        engine.simulate(trace, spec, pol, dynamics="site_outage")
    """
    from repro_torch.core import policy as policy_mod

    base = (policy_mod.get(policy_or_name)
            if isinstance(policy_or_name, str) else policy_or_name)
    return BackupPolicy(base, k)
