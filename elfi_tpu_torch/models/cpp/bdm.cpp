// Birth-Death-Mutation (BDM) process simulator (Tanaka et al. 2006,
// Genetics 173:1511-1520) with the Stadler (2011) stopping variant.
//
// Native example simulator for elfi_tpu_torch (a copy of elfi_tpu's),
// driven from Python through elfi_tpu_torch.tools.external_operation with
// a parameter-file handshake.  CLI contract (kept compatible with ELFI's
// examples/cpp/bdm.cpp):
//
//   bdm <alpha> <delta> <theta> <N> [--seed S] [--mode M]
//   bdm <input_file>              [--seed S] [--mode M]
//
// The input file holds one "alpha delta theta N" row per simulation; each
// simulated population is written to stdout as N space-separated cluster
// sizes (zero-padded), one row per simulation.
//
// Process: a population of genotype clusters starts from one individual.
// Events occur proportional to per-individual rates: birth (alpha) grows
// the individual's cluster, death (delta) shrinks it, mutation (theta)
// moves the individual into a fresh singleton cluster.  Simulation stops
// when the population reaches N (mode 0) or just before it would exceed N
// (mode 1).

#include <cstdint>
#include <cstring>
#include <ctime>
#include <fstream>
#include <iostream>
#include <numeric>
#include <random>
#include <string>
#include <vector>

namespace {

struct Options {
    uint32_t seed = static_cast<uint32_t>(std::time(nullptr));
    int mode = 0;
};

class BdmSimulator {
  public:
    BdmSimulator(uint32_t seed, int mode) : rng_(seed), mode_(mode) {}

    // Returns the final cluster-size vector (length N, zero padded).
    std::vector<unsigned> run(double alpha, double delta, double theta,
                              unsigned n_target) {
        std::vector<unsigned> clusters(n_target, 0);
        clusters[0] = 1;
        unsigned pop = 1;
        std::size_t active_end = 1;  // clusters[0:active_end] may be nonzero

        const double rate_birth = alpha;
        const double rate_death = alpha + delta;
        const double rate_total = alpha + delta + theta;
        const unsigned stop_at = (mode_ == 1) ? n_target + 1 : n_target;

        int last_event = -1;
        std::size_t last_cluster = 0;
        while (pop > 0 && pop < stop_at) {
            const double u = uniform_(rng_) * rate_total;
            last_event = (u < rate_birth) ? 0 : (u < rate_death) ? 1 : 2;
            last_cluster = pick_cluster(clusters, pop, active_end);

            switch (last_event) {
                case 0:  // birth
                    ++clusters[last_cluster];
                    ++pop;
                    break;
                case 1:  // death
                    --clusters[last_cluster];
                    --pop;
                    break;
                default:  // mutation: move one member to a new cluster
                    if (clusters[last_cluster] > 1) {
                        --clusters[last_cluster];
                        for (std::size_t i = 0; i < clusters.size(); ++i) {
                            if (clusters[i] == 0) {
                                clusters[i] = 1;
                                if (i + 1 > active_end) active_end = i + 1;
                                break;
                            }
                        }
                    }
                    break;
            }
        }

        // Stadler stopping: revert the birth that would exceed N.
        if (mode_ == 1 && last_event == 0 && pop == stop_at) {
            --clusters[last_cluster];
        }
        return clusters;
    }

  private:
    // Draw an individual uniformly and return its cluster index.
    std::size_t pick_cluster(const std::vector<unsigned>& clusters,
                             unsigned pop, std::size_t active_end) {
        const double u = uniform_(rng_) * pop;
        double cum = 0.0;
        for (std::size_t i = 0; i < active_end; ++i) {
            cum += clusters[i];
            if (cum > u) return i;
        }
        return active_end - 1;  // numerical edge; u == pop
    }

    std::mt19937 rng_;
    int mode_;
    std::uniform_real_distribution<double> uniform_{0.0, 1.0};
};

void print_row(const std::vector<unsigned>& clusters) {
    for (std::size_t i = 0; i < clusters.size(); ++i) {
        if (i) std::cout << ' ';
        std::cout << clusters[i];
    }
    std::cout << '\n';
}

void usage() {
    std::cout << "Usage: bdm <alpha> <delta> <theta> <N> "
                 "[--seed S] [--mode M]\n"
                 "   or: bdm <input_file> [--seed S] [--mode M]\n";
}

}  // namespace

int main(int argc, char* argv[]) {
    Options opt;
    std::vector<std::string> positional;
    for (int i = 1; i < argc; ++i) {
        if (std::strcmp(argv[i], "--seed") == 0 && i + 1 < argc) {
            opt.seed = static_cast<uint32_t>(std::stoul(argv[++i]));
        } else if (std::strcmp(argv[i], "--mode") == 0 && i + 1 < argc) {
            opt.mode = std::stoi(argv[++i]);
        } else {
            positional.emplace_back(argv[i]);
        }
    }

    BdmSimulator sim(opt.seed, opt.mode);

    if (positional.size() == 4) {
        const double alpha = std::stod(positional[0]);
        const double delta = std::stod(positional[1]);
        const double theta = std::stod(positional[2]);
        const unsigned n = static_cast<unsigned>(std::stoul(positional[3]));
        print_row(sim.run(alpha, delta, theta, n));
        return 0;
    }
    if (positional.size() == 1) {
        std::ifstream in(positional[0]);
        if (!in) {
            std::cerr << "Could not open input file " << positional[0]
                      << '\n';
            return 1;
        }
        double alpha, delta, theta;
        unsigned n;
        while (in >> alpha >> delta >> theta >> n) {
            print_row(sim.run(alpha, delta, theta, n));
        }
        return 0;
    }
    usage();
    return positional.empty() ? 0 : 1;
}
