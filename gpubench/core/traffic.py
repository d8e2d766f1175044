"""The one traffic generator: requests from a traffic file and a seed.

A traffic file gives the flow, the batch (prompts per request), the loop
and the name of a caption grammar (``traffic/grammar/<name>.json``, which
:func:`gpubench.core.spec.cell` reads in its place): COCO labels,
adjectives, verbs, phrases (``{label}`` slots) and adverbs, and the range
of prompt lengths in words.  Every prompt
is "A <adjective> <label> <verb> ..." grown by phrases and adverbs to an
exact word count.  The word counts (the number of word maps an image
asks for) come in pairs of one sum, so every seed asks for the same mix of
lengths in another order (:func:`lengths`).  Prompt ``i`` of the run has the generator seed
``seed·1000 + i``.
"""

import random
from typing import Dict, Iterator, List, Tuple


def _prompt(g: dict, rng: random.Random, words: int) -> Tuple[str, str]:
    """(prompt, its adjective) of exactly ``words`` words."""
    def label():
        return rng.choice(g['labels'])

    parts = ['A', rng.choice(g['adjectives']), *label().split(), rng.choice(g['verbs'])]
    while len(parts) < words:
        left = words - len(parts)
        fills = [p.replace('{label}', label()).split() for p in g['phrases']]
        fits = [f for f in fills if len(f) <= left]
        parts += rng.choice(fits) if fits and rng.random() < 0.8 else [rng.choice(g['adverbs'])]
    if len(parts) > words:  # a two-word label in a five-word prompt
        parts = parts[:words]
    return ' '.join(parts) + '.', parts[1]


def swap_adjective(g: dict, prompt: str, adjective: str, rng: random.Random) -> str:
    """``prompt`` with its adjective replaced by another of the grammar's:
    the counterfactual of the attention transplant."""
    other = rng.choice([a for a in g['adjectives'] if a != adjective])
    words = prompt.split(' ')
    words[1] = other
    return ' '.join(words)


def lengths(g: dict, seed: int, count: int) -> List[int]:
    """Word counts of the first ``count`` prompts.  The range is cut into
    pairs of lengths with one sum (5 and 14, 6 and 13, ...); each block of
    pairs, and each pair, in its own seeded order.  So any two consecutive
    prompts from an even index hold the same number of words whatever the
    seed, and a window's word maps differ between seeds by one prompt's
    at most."""
    lo, hi = g['min_words'], g['max_words']
    pairs = [(a, lo + hi - a) for a in range(lo, (lo + hi) // 2 + 1)]
    out: List[int] = []
    block = 0
    while len(out) < count:
        rng = random.Random(f'{seed}:lengths:{block}')
        order = pairs[:]
        rng.shuffle(order)
        for a, b in order:
            out += [a, b] if rng.random() < 0.5 else [b, a]
        block += 1
    return out[:count]


def requests(traffic: dict, seed: int, start: int = 0) -> Iterator[Dict]:
    """Request ``k`` = ``start``, ``start`` + 1, …: ``prompts`` (``batch``
    of them), their generator ``seeds`` and, for the transplant, each
    prompt's ``counterfactual``.  ``start`` < 0 gives requests that the
    measured ones never repeat (the warm-up)."""
    g, batch = traffic['grammar'], traffic['batch']
    k = start
    while True:
        first = k * batch
        sizes = lengths(g, seed, first + batch) if first >= 0 else [g['max_words']] * batch
        prompts, swaps = [], []
        for j in range(batch):
            rng = random.Random(f'{seed}:prompt:{first + j}')
            p, adjective = _prompt(g, rng, sizes[first + j] if first >= 0 else sizes[j])
            prompts.append(p)
            swaps.append(swap_adjective(g, p, adjective, rng))
        yield {'index': k, 'prompts': prompts,
               'seeds': [seed * 1000 + (first + j if first >= 0 else 999 - j)
                         for j in range(batch)],
               'counterfactuals': swaps}
        k += 1
