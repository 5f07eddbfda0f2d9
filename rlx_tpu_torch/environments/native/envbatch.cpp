// Native vectorized environment batcher (the framework's EnvPool equivalent).
//
// The reference relies on the external C++ EnvPool for lock-free vectorized
// host environments (`rl_x/environments/envpool/*`); this file provides the
// same capability in-repo: classic-control environments stepped in C++ with a
// persistent thread pool, same-step auto-reset, and episode statistics —
// exposed through a minimal C ABI consumed via ctypes
// (rlx_tpu/environments/native/batcher.py) and bridged into the fused TPU
// programs via io_callback.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libenvbatch.so envbatch.cpp -lpthread
//
// Env dynamics mirror the device-resident implementations exactly
// (rlx_tpu/environments/classic/{pendulum,cart_pole}/tpu/environment.py), so
// golden tests can compare native vs device transitions.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr double PI = 3.14159265358979323846;

// ---------------------------------------------------------------- envs

struct PendulumEnv {
    static constexpr int kObsDim = 3;
    static constexpr int kActDim = 1;
    static constexpr bool kDiscrete = false;
    static constexpr int kHorizon = 200;

    double theta = 0.0, theta_dot = 0.0;

    void reset(std::mt19937& rng) {
        std::uniform_real_distribution<double> th(-PI, PI), vel(-1.0, 1.0);
        theta = th(rng);
        theta_dot = vel(rng);
    }

    void observe(float* obs) const {
        obs[0] = static_cast<float>(std::cos(theta));
        obs[1] = static_cast<float>(std::sin(theta));
        obs[2] = static_cast<float>(theta_dot);
    }

    // returns (reward, terminated)
    std::pair<float, bool> step(const float* action, std::mt19937&) {
        constexpr double g = 10.0, m = 1.0, l = 1.0, dt = 0.05;
        double u = std::max(-2.0, std::min(2.0, static_cast<double>(action[0])));
        double angle = std::fmod(theta + PI, 2.0 * PI);
        if (angle < 0) angle += 2.0 * PI;
        angle -= PI;
        double cost = angle * angle + 0.1 * theta_dot * theta_dot + 0.001 * u * u;
        theta_dot += (3.0 * g / (2.0 * l) * std::sin(theta) + 3.0 / (m * l * l) * u) * dt;
        theta_dot = std::max(-8.0, std::min(8.0, theta_dot));
        theta += theta_dot * dt;
        return {static_cast<float>(-cost), false};
    }
};

struct CartPoleEnv {
    static constexpr int kObsDim = 4;
    static constexpr int kActDim = 1;  // one int action
    static constexpr bool kDiscrete = true;
    static constexpr int kHorizon = 500;

    double x = 0, x_dot = 0, theta = 0, theta_dot = 0;

    void reset(std::mt19937& rng) {
        std::uniform_real_distribution<double> u(-0.05, 0.05);
        x = u(rng); x_dot = u(rng); theta = u(rng); theta_dot = u(rng);
    }

    void observe(float* obs) const {
        obs[0] = static_cast<float>(x);
        obs[1] = static_cast<float>(x_dot);
        obs[2] = static_cast<float>(theta);
        obs[3] = static_cast<float>(theta_dot);
    }

    std::pair<float, bool> step(const float* action, std::mt19937&) {
        constexpr double gravity = 9.8, masscart = 1.0, masspole = 0.1,
                         length = 0.5, force_mag = 10.0, dt = 0.02;
        constexpr double total_mass = masscart + masspole;
        constexpr double polemass_length = masspole * length;
        double force = (action[0] > 0.5) ? force_mag : -force_mag;
        double cos_t = std::cos(theta), sin_t = std::sin(theta);
        double temp = (force + polemass_length * theta_dot * theta_dot * sin_t) / total_mass;
        double theta_acc = (gravity * sin_t - cos_t * temp) /
                           (length * (4.0 / 3.0 - masspole * cos_t * cos_t / total_mass));
        double x_acc = temp - polemass_length * theta_acc * cos_t / total_mass;
        x += dt * x_dot;
        x_dot += dt * x_acc;
        theta += dt * theta_dot;
        theta_dot += dt * theta_acc;
        bool terminated = std::abs(x) > 2.4 || std::abs(theta) > 12.0 * 2.0 * PI / 360.0;
        return {1.0f, terminated};
    }
};

// ------------------------------------------------------------ thread pool

class ThreadPool {
  public:
    explicit ThreadPool(int nr_threads) : stop_(false), pending_(0) {
        for (int i = 0; i < nr_threads; ++i) {
            workers_.emplace_back([this] {
                for (;;) {
                    std::function<void()> task;
                    {
                        std::unique_lock<std::mutex> lock(mu_);
                        cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
                        if (stop_ && tasks_.empty()) return;
                        task = std::move(tasks_.back());
                        tasks_.pop_back();
                    }
                    task();
                    if (--pending_ == 0) {
                        std::lock_guard<std::mutex> lock(done_mu_);
                        done_cv_.notify_all();
                    }
                }
            });
        }
    }

    ~ThreadPool() {
        {
            std::lock_guard<std::mutex> lock(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& w : workers_) w.join();
    }

    void run_chunks(int total, const std::function<void(int, int)>& fn) {
        int nr = static_cast<int>(workers_.size());
        int chunk = (total + nr - 1) / nr;
        int launched = 0;
        {
            std::lock_guard<std::mutex> lock(mu_);
            for (int start = 0; start < total; start += chunk) {
                int end = std::min(start + chunk, total);
                tasks_.emplace_back([fn, start, end] { fn(start, end); });
                ++launched;
            }
            pending_ += launched;
        }
        cv_.notify_all();
        std::unique_lock<std::mutex> lock(done_mu_);
        done_cv_.wait(lock, [this] { return pending_.load() == 0; });
    }

  private:
    std::vector<std::thread> workers_;
    std::vector<std::function<void()>> tasks_;
    std::mutex mu_, done_mu_;
    std::condition_variable cv_, done_cv_;
    std::atomic<bool> stop_;
    std::atomic<int> pending_;
};

// -------------------------------------------------------------- batcher

template <typename Env>
struct Batch {
    std::vector<Env> envs;
    std::vector<std::mt19937> rngs;
    std::vector<float> episode_return;
    std::vector<int> episode_length;
    std::vector<float> last_stats;  // [nr_envs, 2]
    ThreadPool pool;
    int nr_envs;

    Batch(int n, uint64_t seed, int nr_threads)
        : envs(n), rngs(), episode_return(n, 0.f), episode_length(n, 0),
          last_stats(2 * n, 0.f), pool(nr_threads), nr_envs(n) {
        rngs.reserve(n);
        for (int i = 0; i < n; ++i) rngs.emplace_back(static_cast<uint32_t>(seed + i));
    }

    void reset(float* obs_out) {
        pool.run_chunks(nr_envs, [&](int start, int end) {
            for (int i = start; i < end; ++i) {
                envs[i].reset(rngs[i]);
                envs[i].observe(obs_out + i * Env::kObsDim);
                episode_return[i] = 0.f;
                episode_length[i] = 0;
                last_stats[2 * i] = last_stats[2 * i + 1] = 0.f;
            }
        });
    }

    void step(const float* actions, float* obs_out, float* final_obs_out,
              float* reward_out, uint8_t* term_out, uint8_t* trunc_out,
              float* stats_out) {
        pool.run_chunks(nr_envs, [&](int start, int end) {
            for (int i = start; i < end; ++i) {
                auto [reward, terminated] = envs[i].step(actions + i * Env::kActDim, rngs[i]);
                envs[i].observe(final_obs_out + i * Env::kObsDim);
                episode_return[i] += reward;
                episode_length[i] += 1;
                bool truncated = !terminated && episode_length[i] >= Env::kHorizon;
                reward_out[i] = reward;
                term_out[i] = terminated ? 1 : 0;
                trunc_out[i] = truncated ? 1 : 0;
                if (terminated || truncated) {
                    last_stats[2 * i] = episode_return[i];
                    last_stats[2 * i + 1] = static_cast<float>(episode_length[i]);
                    episode_return[i] = 0.f;
                    episode_length[i] = 0;
                    envs[i].reset(rngs[i]);
                }
                envs[i].observe(obs_out + i * Env::kObsDim);
                stats_out[2 * i] = last_stats[2 * i];
                stats_out[2 * i + 1] = last_stats[2 * i + 1];
            }
        });
    }
};

struct AnyBatch {
    int env_type;  // 0 = pendulum, 1 = cartpole
    Batch<PendulumEnv>* pendulum = nullptr;
    Batch<CartPoleEnv>* cartpole = nullptr;
};

}  // namespace

extern "C" {

void* envbatch_create(const char* env_id, int nr_envs, uint64_t seed, int nr_threads) {
    if (nr_threads <= 0) {
        nr_threads = std::max(1u, std::thread::hardware_concurrency() / 2);
    }
    auto* any = new AnyBatch();
    if (std::strcmp(env_id, "pendulum") == 0) {
        any->env_type = 0;
        any->pendulum = new Batch<PendulumEnv>(nr_envs, seed, nr_threads);
    } else if (std::strcmp(env_id, "cart_pole") == 0) {
        any->env_type = 1;
        any->cartpole = new Batch<CartPoleEnv>(nr_envs, seed, nr_threads);
    } else {
        delete any;
        return nullptr;
    }
    return any;
}

int envbatch_obs_dim(void* handle) {
    auto* any = static_cast<AnyBatch*>(handle);
    return any->env_type == 0 ? PendulumEnv::kObsDim : CartPoleEnv::kObsDim;
}

int envbatch_horizon(void* handle) {
    auto* any = static_cast<AnyBatch*>(handle);
    return any->env_type == 0 ? PendulumEnv::kHorizon : CartPoleEnv::kHorizon;
}

void envbatch_reset(void* handle, float* obs_out) {
    auto* any = static_cast<AnyBatch*>(handle);
    if (any->env_type == 0) any->pendulum->reset(obs_out);
    else any->cartpole->reset(obs_out);
}

void envbatch_step(void* handle, const float* actions, float* obs_out,
                   float* final_obs_out, float* reward_out, uint8_t* term_out,
                   uint8_t* trunc_out, float* stats_out) {
    auto* any = static_cast<AnyBatch*>(handle);
    if (any->env_type == 0) {
        any->pendulum->step(actions, obs_out, final_obs_out, reward_out,
                            term_out, trunc_out, stats_out);
    } else {
        any->cartpole->step(actions, obs_out, final_obs_out, reward_out,
                            term_out, trunc_out, stats_out);
    }
}

void envbatch_destroy(void* handle) {
    auto* any = static_cast<AnyBatch*>(handle);
    delete any->pendulum;
    delete any->cartpole;
    delete any;
}

}  // extern "C"
