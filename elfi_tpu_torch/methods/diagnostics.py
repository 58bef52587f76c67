"""Summary-statistics selection diagnostics (Nunes & Balding 2010;
counterpart of :mod:`elfi_tpu.methods.diagnostics`).

Each candidate's rejection runs batch at a time (``fused=False``) with the
selector's pool of the simulator's output, so every candidate sees the
same simulations: the first simulates, the others replay.  The
rejections run on the global backend's device; the entropy and MRSSE
statistics are scipy and numpy on the accepted parameters."""

from __future__ import annotations

import logging
from itertools import combinations

import numpy as np
from scipy.spatial import cKDTree
from scipy.special import digamma, gamma

logger = logging.getLogger(__name__)

__all__ = ["TwoStageSelection"]


class TwoStageSelection:
    """Two-stage summary-statistics selection: minimum-entropy screening,
    then minimum MRSSE over the closest datasets."""

    def __init__(self, simulator, fn_distance, list_ss=None, prepared_ss=None,
                 max_cardinality=4, seed=0):
        from ..store import OutputPool
        if list_ss is None and prepared_ss is None:
            raise ValueError("No summary statistics to assess")
        self.simulator = simulator
        self.fn_distance = fn_distance
        self.seed = seed
        if prepared_ss is not None:
            self.ss_candidates = prepared_ss
        else:
            self.ss_candidates = self._combine_ss(list_ss, max_cardinality)
        self.pool = OutputPool([simulator.name])

    @staticmethod
    def _combine_ss(list_ss, max_cardinality):
        max_cardinality = min(max_cardinality, len(list_ss))
        out = []
        for i in range(max_cardinality):
            out.extend(combinations(list_ss, i + 1))
        return out

    def run(self, n_sim, n_acc=None, n_closest=None, batch_size=1, k=4):
        """Return the summary-statistics combination with the optimal
        performance."""
        if n_acc is None:
            n_acc = int(n_sim / 100)
        if n_closest is None:
            n_closest = int(n_acc / 100)
        if n_sim < n_acc or n_acc < n_closest or n_closest == 0:
            raise ValueError("The number of simulations is too small")

        # Stage 1: minimum entropy
        thetas = {}
        E_me = np.inf
        names_me = []
        thetas_closest = None
        for set_ss in self.ss_candidates:
            names = [ss.__name__ for ss in set_ss]
            thetas_ss = self._obtain_accepted_thetas(set_ss, n_sim, n_acc,
                                                     batch_size)
            thetas[set_ss] = thetas_ss
            E_ss = self._calc_entropy(thetas_ss, n_acc, k)
            if (E_ss == E_me and len(names_me) > len(names)) or E_ss < E_me:
                E_me = E_ss
                names_me = names
                thetas_closest = thetas_ss[:n_closest]
            logger.info("Combination %s shows entropy %f", names, E_ss)
        logger.info("Minimum entropy %f found in %s", E_me, names_me)

        # Stage 2: minimum MRSSE on the closest datasets
        MRSSE_min = np.inf
        names_min = []
        best = None
        for set_ss in self.ss_candidates:
            names = [ss.__name__ for ss in set_ss]
            MRSSE_ss = self._calc_MRSSE(set_ss, thetas_closest,
                                        thetas[set_ss])
            if (MRSSE_ss == MRSSE_min and len(names_min) > len(names)) \
                    or MRSSE_ss < MRSSE_min:
                MRSSE_min = MRSSE_ss
                names_min = names
                best = set_ss
            logger.info("Combination %s shows MRSSE %f", names, MRSSE_ss)
        logger.info("Minimum MRSSE %f found in %s", MRSSE_min, names_min)
        return best

    def _obtain_accepted_thetas(self, set_ss, n_sim, n_acc, batch_size):
        from ..model.model import Discrepancy, Distance, Summary
        from .samplers import Rejection
        m = self.simulator.model.copy()
        list_ss = [Summary(ss, m[self.simulator.name], model=m)
                   for ss in set_ss]
        if isinstance(self.fn_distance, str):
            d = Distance(self.fn_distance, *list_ss, model=m)
        else:
            d = Discrepancy(self.fn_distance, *list_ss, model=m)
        sampler = Rejection(d, batch_size=batch_size, seed=self.seed,
                            pool=self.pool)
        result = sampler.sample(n_acc, n_sim=n_sim, bar=False, fused=False)
        return result.samples_array

    @staticmethod
    def _calc_entropy(thetas_ss, n_acc, k):
        """kNN entropy estimate (Nunes & Balding eq. 2)."""
        q = thetas_ss.shape[1]
        searcher = cKDTree(thetas_ss)
        dists, _ = searcher.query(thetas_ss, k=k)
        sum_log = float(np.sum(np.log(np.maximum(dists[:, -1], 1e-300))))
        return (np.log(np.pi ** (q / 2) / gamma(q / 2 + 1)) - digamma(k)
                + np.log(n_acc) + (q / n_acc) * sum_log)

    @staticmethod
    def _calc_MRSSE(set_ss, thetas_obs, thetas_sim):
        """Mean root sum of squared errors over closest datasets."""
        return float(np.mean([np.linalg.norm(thetas_sim - obs)
                              for obs in thetas_obs]))
