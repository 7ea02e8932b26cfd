"""A rating matrix of the Netflix Prize data set's shape, on the device from
a seed.

The published shape fixes the users, the items and the number of ratings;
the distributions are assumed (the configuration's ``assumed``): item
popularity Zipf, user activity log-normal, ratings uniform integers.  The
pairs are drawn by rank with ``shape``; ``gen`` (the seed) says which user
and which item each rank is, and draws the ratings.  Every user and every item has a
rating, as in the data set, and no (user, item) pair is rated twice: pairs
are drawn from the two popularity laws, repeats dropped, and as many of the
rest kept, uniformly at random, as the shape asks for.
"""

from __future__ import annotations

from typing import Dict

import torch

DRAW_CHUNK = 1 << 25


def _draw(cdf: torch.Tensor, count: int, gen: torch.Generator
          ) -> torch.Tensor:
  u = torch.rand(count, generator=gen, device=cdf.device, dtype=torch.float64)
  return torch.searchsorted(cdf, u * cdf[-1]).clamp_(max=cdf.numel() - 1)


def pair_keys(users: int, items: int, count: int, user_cdf, item_cdf, gen
              ) -> torch.Tensor:
  """``count`` pairs drawn from the two laws, as ``user * items + item``
  (users and items by their rank in the laws)."""
  out = []
  for lo in range(0, count, DRAW_CHUNK):
    k = min(DRAW_CHUNK, count - lo)
    u = _draw(user_cdf, k, gen)
    i = _draw(item_cdf, k, gen)
    out.append(u * items + i)
  return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                 device=user_cdf.device)


def make(config: dict, shape: torch.Generator, gen: torch.Generator, device
         ) -> Dict[str, object]:
  users, items = int(config["users"]), int(config["items"])
  target = int(config["ratings"])
  assumed = config["assumed"]
  if not users + items <= target <= users * items:
    raise ValueError("the ratings cannot cover every user and item once")
  rank = torch.arange(1, items + 1, dtype=torch.float64, device=device)
  item_cdf = torch.cumsum(rank ** -float(assumed["item_zipf_exponent"]), 0)
  activity = torch.exp(float(assumed["user_lognormal_sigma"]) * torch.randn(
      users, generator=shape, device=device, dtype=torch.float64))
  user_cdf = torch.cumsum(activity, 0)
  # One rating of every user and of every item.
  every_user = torch.arange(users, device=device) * items + _draw(
      item_cdf, users, shape)
  every_item = _draw(user_cdf, items, shape) * items + torch.arange(
      items, device=device)
  sure = torch.unique(torch.cat([every_user, every_item]))
  need = target - sure.numel()
  drawn = torch.zeros(0, dtype=torch.int64, device=device)
  count = int(float(assumed["draws_per_rating"]) * target)
  for _ in range(8):
    fresh = pair_keys(users, items, count, user_cdf, item_cdf, shape)
    drawn = torch.unique(torch.cat([drawn, fresh]))
    drawn = drawn[~torch.isin(drawn, sure)]
    if drawn.numel() >= need:
      break
    count = max(need // 4, 1)
  else:
    raise RuntimeError(f"drew {drawn.numel()} distinct pairs of {need}")
  keep = torch.randperm(drawn.numel(), generator=shape, device=device)
  keys = torch.cat([sure, drawn[keep[:need]]])
  del drawn, keep
  # The seed's part: which user and which item each rank is, and the
  # ratings, in the order of (user, item).
  user_label = torch.randperm(users, generator=gen, device=device)
  item_label = torch.randperm(items, generator=gen, device=device)
  keys = torch.sort(user_label[keys // items] * items
                    + item_label[keys % items]).values
  rating = torch.randint(1, 6, (target,), generator=gen, device=device
                         ).to(torch.float32)
  return {"users": users, "items": items, "user": keys // items,
          "item": keys % items, "rating": rating}
