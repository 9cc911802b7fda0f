"""Final-answer selection over completed branches."""
from __future__ import annotations

from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

# (generated tokens, reward[, truncated]) — the scheduler appends a
# truncation flag (force-eviction / max-token cap); selection ignores
# trailing fields so older 2-tuples keep working
CompletedBranch = Tuple[List[int], float]


def best_of_n(completed: Sequence[CompletedBranch],
              answer_fn: Callable) -> Optional[object]:
    """SART's default: answer of the highest-reward completed branch."""
    best = None
    for tokens, reward, *_ in completed:
        ans = answer_fn(tokens)
        if ans is None:
            continue
        if best is None or reward > best[0]:
            best = (reward, ans)
    return best[1] if best else None


def majority_vote(completed: Sequence[CompletedBranch],
                  answer_fn: Callable) -> Optional[object]:
    """Self-Consistency: most frequent extracted answer; reward breaks ties."""
    votes = Counter()
    best_reward = {}
    for tokens, reward, *_ in completed:
        ans = answer_fn(tokens)
        if ans is None:
            continue
        votes[ans] += 1
        best_reward[ans] = max(best_reward.get(ans, 0.0), reward)
    if not votes:
        return None
    top = max(votes, key=lambda a: (votes[a], best_reward[a]))
    return top


def weighted_vote(completed: Sequence[CompletedBranch],
                  answer_fn: Callable) -> Optional[object]:
    """Reward-weighted voting (beyond-paper variant)."""
    mass = {}
    for tokens, reward, *_ in completed:
        ans = answer_fn(tokens)
        if ans is None:
            continue
        mass[ans] = mass.get(ans, 0.0) + reward
    if not mass:
        return None
    return max(mass, key=mass.get)
